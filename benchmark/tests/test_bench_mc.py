"""The MC-dropout serving cell: found by name, its readers, and its check.

On the CPU at a size a test holds (the MC configuration's widths on 64x96
frames, 4 frames a request, 2 passes), through the harness's own
``run_cell``: a sound run is correct; a program whose masks keep every
channel, or are folded from another seed, is not, nor is the fp8 control.
The ``card`` tests repeat the faults and the control at the cell's size.
"""

import contextlib
import dataclasses

import pytest
import torch

from benchmark import calibrate_mc, cells, yardstick, yardstick_mc
from benchmark.readers import ReadContext
from benchmark.reference.quant import fp8
from benchmark.run import run_cell
from benchmark.tests.tiny import LIMITS
from benchmark.trace import WINDOW, Trace

CELL = "mc_predict_b32"
SEED = 2**32 + 977
NEW = ("mc_step_mfu.serve", "mc_eval_conv_roofline_pct", "mc_outconv_roofline_pct",
       "mc_idle_ms.masks")
TINY = dict(driver="predict_mc", request_frames=4, height=64, width=96, monte_carlo_steps=2,
            pool_requests=3, warmup_requests=1, checked_requests=2, check_block=2)
MS = 1_000_000  # ns


def tiny_cell():
    """The MC cell at 64x96, held to the serving cells' CPU limits
    (``tiny.LIMITS``): its sound runs read 1.2-2.0 a request and 1.5-2.5 a
    frame on three seeds, the faults tens to thousands."""
    return dataclasses.replace(cells.load_cell(CELL), traffic=dict(TINY),
                               limits=dict(LIMITS["serve"]))


def test_the_cell_loads_by_name_with_its_metrics():
    cell = cells.load_cell(CELL)
    assert cell.chips == 1 and cells.driver_class(cell.traffic).kind == "serve"
    assert cell.config["name"] == "nyuv2_depth_mc_s2_f21" and cell.config["reduced"] == []
    assert all(cell.config["task"][f"{k}_dropout_rate"] == 0.1
               for k in ("encoder", "core", "decoder"))
    assert cell.traffic["monte_carlo_steps"] == 8 and cell.traffic["request_frames"] == 32
    assert {m["name"] for m in cell.end_to_end} == {"serve_frames_per_s",
                                                     "serve_latency_p95_ms", "peak_mem_gib",
                                                     "setup_s"}
    names = [m["name"] for m in cell.per_layer]
    assert set(NEW) <= set(names)
    # the one-pass counts do not hold at T passes
    assert "step_mfu.serve" not in names and "eval_conv_roofline_pct" not in names
    assert set(cell.limits) == set(cells.load_cell("nyuv2_predict_b32").limits)


def _ctx(device, host, **counts):
    cell = cells.load_cell(CELL)
    return ReadContext(trace=Trace(device, host), counts=counts, config=cell.config,
                       traffic=cell.traffic)


@pytest.mark.parametrize("name", NEW)
def test_each_new_reader_reads_nothing_without_its_spans_or_counts(name):
    # a window with requests and the MC route's kernels, but none of the
    # program's MC spans or counts (a program without them) ...
    host = [(0, 100 * MS, WINDOW), (10 * MS, 90 * MS, "bench.request")]
    device = [(20 * MS, 30 * MS, "fused_double_conv_tc<true>"),
              (30 * MS, 31 * MS, "conv1x1_kernel<false, 2>")]
    if name in ("mc_step_mfu.serve", "mc_idle_ms.masks"):  # no passes, no draw span
        assert cells.reader(name)(_ctx(device, host, requests=1, frames=32)) is None
    # ... and each roofline without its kernel's time
    kernel = {"mc_eval_conv_roofline_pct": "fused", "mc_outconv_roofline_pct": "conv1x1"}
    if name in kernel:
        rest = [d for d in device if not d[2].startswith(kernel[name])]
        assert cells.reader(name)(_ctx(rest, host, requests=1, frames=32, passes=256)) is None
        assert cells.reader(name)(_ctx(device, host, requests=1, frames=32)) is not None


def test_the_new_readers_on_a_trace_built_by_hand():
    host = [(0, 1000 * MS, WINDOW), (10 * MS, 12 * MS, "mimo.dropout.draw"),
            (510 * MS, 514 * MS, "mimo.dropout.draw")]
    device = [(11 * MS, 11.5 * MS, "void rand_kernel"),
              (100 * MS, 300 * MS, "fused_double_conv_tc<true>"),
              (300 * MS, 310 * MS, "conv1x1_kernel<false, 2>")]
    c = _ctx(device, host, requests=2, frames=64, passes=512)
    cfg, tr = c.config, c.traffic
    h, w, b, t = tr["height"], tr["width"], tr["request_frames"], tr["monte_carlo_steps"]
    # 2 + 4 ms in the draws, 0.5 of them busy, over two requests
    assert cells.reader("mc_idle_ms.masks")(c) == pytest.approx((6 - 0.5) / 2)
    flops = yardstick.model_flops(cfg, "serve", h, w)
    assert cells.reader("mc_step_mfu.serve")(c) == pytest.approx(
        100 * flops * 512 / 1.0 / yardstick.PEAKS["bf16_flops"])
    bound = yardstick.bound_seconds(yardstick_mc.mc_outconv_sites(cfg, b, t, h, w))
    assert cells.reader("mc_outconv_roofline_pct")(c) == pytest.approx(100 * bound * 2 / 0.010)
    bound = yardstick.bound_seconds(yardstick_mc.mc_eval_conv_sites(cfg, b, t, h, w))
    assert cells.reader("mc_eval_conv_roofline_pct")(c) == pytest.approx(100 * bound * 2 / 0.2)


def test_the_mc_site_tables():
    cfg = cells.load_cell(CELL).config
    f, s, oc = cfg["filter_base_count"], cfg["num_subnetworks"], cfg["out_channels"]
    one = yardstick.eval_conv_sites(cfg, 4 * 3, 32, 48)
    mc = yardstick_mc.mc_eval_conv_sites(cfg, 4, 3, 32, 48)
    assert [x["site"] for x in mc] == ["in_conv", "down1", "up3", "decoder"]
    assert mc[:3] == one[:3]  # the folded passes are a batch of B * T frames
    px = s * 4 * 3 * 32 * 48
    # the decoder site less its fused out-conv, which K11 now does
    assert mc[3]["flops"] == pytest.approx(one[3]["flops"] - 2.0 * f * oc * px)
    assert mc[3]["bytes"] > one[3]["bytes"]  # F channels written, not OC
    (outc,) = yardstick_mc.mc_outconv_sites(cfg, 4, 3, 32, 48)
    assert outc["bytes"] == 2 * px * (f + oc) + 2 * s * f * oc + 4 * s * oc


def run(fault=contextlib.nullcontext):
    torch.manual_seed(0)
    with fault():
        return run_cell(tiny_cell(), SEED, 0.3, False, "cpu")


def test_a_sound_mc_run_is_correct():
    res = run()
    assert res["correct"], res["check"]


@pytest.mark.parametrize("fault", sorted(calibrate_mc.FAULTS))
def test_a_fault_of_the_masks_is_not_correct(fault):
    res = run(calibrate_mc.FAULTS[fault])
    assert not res["correct"], res["check"]


def fp8_fails(cell, device):
    drv = cells.driver_class(cell.traffic)(cell.config, cell.traffic, SEED, device)
    drv.setup()
    frames = drv._frames(0)
    got = drv.judge(drv.reference(frames, quant=fp8), frames)
    return any(got[k] > lim for k, lim in cell.limits.items())


def test_the_fp8_control_is_not_correct():
    assert fp8_fails(tiny_cell(), "cpu")


@pytest.mark.card
@pytest.mark.parametrize("fault", sorted(calibrate_mc.FAULTS))
def test_a_fault_of_the_masks_is_not_correct_at_the_cells_size(card, fault):
    with calibrate_mc.FAULTS[fault]():
        res = run_cell(cells.load_cell(CELL), SEED, 2.0, False, card)
    assert not res["correct"], res["check"]


@pytest.mark.card
def test_the_fp8_control_is_not_correct_at_the_cells_size(card):
    assert fp8_fails(cells.load_cell(CELL), card)
