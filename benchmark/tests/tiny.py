"""Cells at a size a CPU test holds: the recipe's configuration (S=2,
filter_base_count 21) on 64x96 frames, a few rows."""

from benchmark import cells

TRAFFIC = {
    "train": dict(driver="train_step", batch=4, height=64, width=96, split_frames=20,
                  checked_steps=3, warmup_steps=1),
    "serve": dict(driver="predict", request_frames=4, height=64, width=96, pool_requests=3,
                  warmup_requests=1, checked_requests=2, check_block=2),
}
CELL = {"train": "nyuv2_train_b64", "serve": "nyuv2_predict_b32"}
# limits at this size (the recipe's widths on 64x96 frames), set from CPU
# readings: train on four seeds, sound runs read loss1_gap 0.0018-0.0096,
# grad_gap_med and change_gap_med <= 0.05, the fp8 control 0.017-0.041 on
# loss1_gap, and a state left unchanged reads 1 on the median leaf's gaps;
# serve on seven seeds, sound runs read mean_vs_bf16 1.22-1.73,
# aleatoric_vs_bf16 1.35-1.77, epistemic_vs_bf16 1.06-2.49 and, frame by
# frame, 1.52-2.16, 1.57-3.04, 1.55-3.03; the fp8 control 8.77-31.1,
# 8.95-33.8, 9.40-36.7 and 9.28-48.1, 9.77-53.2, 13.4-41.8
LIMITS = {"train": {"loss1_gap": 0.013, "grad_gap_med": 0.2, "change_gap_med": 0.2},
          "serve": {"mean_vs_bf16": 4.0, "aleatoric_vs_bf16": 4.0, "epistemic_vs_bf16": 5.0,
                    "mean_frame_vs_bf16": 5.0, "aleatoric_frame_vs_bf16": 5.5,
                    "epistemic_frame_vs_bf16": 6.0}}


def tiny_config():
    cfg = cells.load_json(cells.BENCH_DIR / "configs" / "nyuv2_depth_s2_f21.json")
    cfg.update(filter_base_count=21)
    return cfg


def tiny_cell(kind: str) -> cells.Cell:
    real = cells.load_cell(CELL[kind])
    return cells.Cell(name=real.name, chips=1, config=tiny_config(),
                      traffic=dict(TRAFFIC[kind]), limits=dict(LIMITS[kind]),
                      end_to_end=real.end_to_end, per_layer=real.per_layer)
