"""Driver of ``MimoUnetTask.train_step``: a training run on a split held on
the card.

Set-up draws the split (``split_frames`` synthetic frames) and the weights
from the seed, pins the split on the card as the program's
``DeviceDataset``, builds one ``TrainState``, and drives it through its
first steps with the window's own call and feed: batches of ``batch``
rows gathered on the card in a seeded epoch order.  The reference follows
the first ``checked_steps`` of them; the window then runs on the same
state.

Readings (each against the float32 reference on the same weights, rows
and input-transform draws):
  loss1_gap     the first step's loss per subnetwork: the gap over the
                reference's mean per-pixel loss magnitude (the NLL's two
                terms can cancel, so the loss itself may sit near 0); worst;
  loss_gap      the same over every checked step;
  grad_gap      the first gradient, as Adam's first moment holds it after
                one step, per leaf: the gap of the norms over the larger
                of the leaf's reference norm and the median leaf's; worst;
  grad_gap_med  the same, the median leaf;
  change_gap    the parameters' change over the checked steps, as for
                ``grad_gap``, over the leaves the reference's first
                gradient moves (norm at least 1e-3 of the median leaf's:
                a conv bias under train-mode BatchNorm has none, and Adam
                moves such a leaf by round-off alone); worst;
  change_gap_med  the same, the median leaf;
  grad_gap_all  the first gradient's norm over all leaves, relative gap.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import inputs
from benchmark.drivers.common import make_task, no_tf32, norm_gaps, synchronize
from benchmark.reference import model as ref_model, train as ref_train

STEP = "bench.step"
MOVED = 1e-3


class Driver:
    kind = "train"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.cfg, self.tr, self.seed, self.device = config, traffic, seed, device
        self.steps = 0

    # ---- set-up ---------------------------------------------------------
    def setup(self) -> None:
        from mimo_unet_torch.data.core import ArrayDataset, DeviceDataset

        cfg, tr, dev = self.cfg, self.tr, self.device
        b, n = tr["batch"], tr["split_frames"]
        split = inputs.frames(self.seed, n, tr["height"], tr["width"], dev)
        self.host = {k: v.cpu().numpy() for k, v in split.items()}
        del split
        self.data = DeviceDataset(ArrayDataset(self.host), device=dev)
        self.order = np.random.default_rng(inputs.sub_seed(self.seed, inputs.ORDER))
        self.queue = []
        self.task = make_task(cfg, self.seed)
        self.state = self.task.init_state(steps_per_epoch=n // b, device=dev)
        start = inputs.weights(cfg, self.seed, dev, serving=False)
        self.state.model.load_state_dict(start)

        named = dict(self.state.model.named_parameters())
        keys = ref_model.parameter_keys(cfg)
        s = cfg["num_subnetworks"]
        self.checked_rows, losses = [], []
        for t in range(tr["checked_steps"]):
            rows, logs = self._step()
            self.checked_rows.append(rows)
            losses.append(torch.stack([logs[f"train_loss_{i}"] for i in range(s)]))
            if t == 0:
                # a leaf Adam never updated has no first moment: it reads 0
                opt = self.state.optimizer.state
                zero = torch.zeros((), device=dev)
                grads = torch.stack([opt[named[k]]["exp_avg"].norm() / 0.1
                                     if "exp_avg" in opt.get(named[k], {}) else zero
                                     for k in keys])
        change = torch.stack([(named[k].detach() - start[k]).norm() for k in keys])
        self.prog = {"losses": torch.stack(losses).cpu().double().numpy(),
                     "grad_norms": grads.cpu().double().numpy(),
                     "change_norms": change.cpu().double().numpy()}
        del start
        for _ in range(tr["warmup_steps"]):
            self._step()
        synchronize(dev)
        self.steps = 0

    def _rows(self) -> np.ndarray:
        b = self.tr["batch"]
        if len(self.queue) < b:
            self.queue = list(self.order.permutation(self.tr["split_frames"]))
        rows, self.queue = np.asarray(self.queue[:b], dtype=np.int64), self.queue[b:]
        return rows

    def _step(self):
        rows = self._rows()
        _, logs, _ = self.task.train_step(self.state, self.data.gather(rows))
        return rows, logs

    # ---- the window -----------------------------------------------------
    def step(self) -> None:
        with record_function(STEP):
            self._step()
        self.steps += 1

    def counts(self) -> dict:
        return {"steps": self.steps, "images": self.steps * self.tr["batch"]}

    def end_to_end(self, elapsed: float) -> dict:
        return {"train_images_per_s": self.steps * self.tr["batch"] / elapsed}

    def release(self) -> None:
        del self.state, self.data, self.task

    # ---- the check ------------------------------------------------------
    def reference(self, quant=ref_model.identity) -> dict:
        dev = self.device
        batches = [{k: torch.as_tensor(v[rows]).to(dev) for k, v in self.host.items()}
                   for rows in self.checked_rows]
        start = inputs.weights(self.cfg, self.seed, dev, serving=False)
        with no_tf32():
            out = ref_train.train_steps(start, batches, self.cfg, self.seed, quant=quant)
        return {"losses": out["losses"].double().numpy(),
                "abs_losses": out["abs_losses"].double().numpy(),
                "grad_norms": np.asarray(out["grad_norms"]),
                "change_norms": np.asarray(out["change_norms"])}

    @staticmethod
    def compare(prog: dict, ref: dict) -> dict:
        loss = np.abs(prog["losses"] - ref["losses"]) / ref["abs_losses"]
        grad = norm_gaps(prog["grad_norms"], ref["grad_norms"])
        g_all = [np.linalg.norm(prog["grad_norms"]), np.linalg.norm(ref["grad_norms"])]
        moved = ref["grad_norms"] >= MOVED * np.median(ref["grad_norms"])
        change = norm_gaps(prog["change_norms"][moved], ref["change_norms"][moved])
        return {"loss1_gap": float(loss[0].max()), "loss_gap": float(loss.max()),
                "grad_gap": float(grad.max()), "grad_gap_med": float(np.median(grad)),
                "change_gap": float(change.max()),
                "change_gap_med": float(np.median(change)),
                "grad_gap_all": float(abs(g_all[0] / g_all[1] - 1.0))}

    def readings(self) -> dict:
        return self.compare(self.prog, self.reference())
