"""Driver of MC-dropout ``Ensemble.predict``: ``drivers/predict.py``'s
closed-loop caller, its member built with the configuration's dropout rates
and served with ``monte_carlo_steps`` passes (the traffic's), each request
one ``predict`` call of ``request_frames`` frames at that ``batch_size``.

Every request passes the same ``seed``, drawn from ``--seed``: a batch's
masks are a function of that seed and the batch's start (the program's
contract, ``reference/mc.py``), so every request draws the masks the
reference draws for its frames.  The check is ``predict``'s: each answer in
units of the gap that the reference rounded to bfloat16 gives, the
reference here being ``reference/mc.py`` with the same masks, served in
blocks of ``check_block`` frames (all their passes).  ``counts()`` adds
``passes``, the MC passes the window's forwards served, read from the
program's ``mc_counts()`` where it has one.
"""

from __future__ import annotations

import random
import time

import numpy as np
import torch

from benchmark import inputs
from benchmark.drivers import predict
from benchmark.drivers.common import make_task, no_tf32, synchronize
from benchmark.reference import mc as ref_mc, model as ref_model

MASKS = 5  # the input stream of the masks' seed (inputs.py's are 0 .. 4)


def _mc_counter(name: str):
    """The program's MC counter function ``name`` (``mc_counts``,
    ``reset_mc_counts``), or None where the program has none."""
    from mimo_unet_torch.models import ensemble

    return getattr(ensemble, name, None)


class Driver(predict.Driver):
    def setup(self) -> None:
        from mimo_unet_torch.models.ensemble import Ensemble

        cfg, tr, dev = self.cfg, self.tr, self.device
        self.b, self.passes = tr["request_frames"], tr["monte_carlo_steps"]
        self.mask_seed = inputs.sub_seed(self.seed, MASKS)
        self._refs = {}
        task = make_task(cfg, self.seed)
        model = task.build_model(device=dev)
        self.params = inputs.weights(cfg, self.seed, dev, serving=True)
        synchronize(dev)
        t0 = time.perf_counter()
        with no_tf32():
            inputs.set_statistics(self.params, cfg, self.seed, dev, tr["height"], tr["width"])
        synchronize(dev)
        self.reference_setup_s = time.perf_counter() - t0
        model.load_state_dict(self.params)
        if torch.device(dev).type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        self.ensemble = Ensemble([(task, model)], monte_carlo_steps=self.passes)
        pool = inputs.frames(self.seed, self.b * tr["pool_requests"], tr["height"],
                             tr["width"], dev)["image"]
        self.pool = (pool.float() / 255.0).cpu().numpy()
        del pool
        self.sample = random.Random(inputs.sub_seed(self.seed, inputs.SAMPLE))
        self.kept = []
        for _ in range(tr["warmup_requests"]):
            self._request(0)
        synchronize(dev)
        self.latencies = []
        reset = _mc_counter("reset_mc_counts")
        if reset is not None:
            reset()

    def _request(self, r: int):
        return self.ensemble.predict(self._frames(r), batch_size=self.b, seed=self.mask_seed)

    def counts(self) -> dict:
        out = super().counts()
        mc_counts = _mc_counter("mc_counts")
        if mc_counts is not None:
            out["passes"] = mc_counts()["passes"]
        return out

    def masks(self, device) -> ref_mc.Masks:
        """The masks of a request's one batch (start 0) of the one member."""
        seed = ref_mc.fold_in(ref_mc.fold_in(self.mask_seed, 0), 0)
        return ref_mc.draw_masks(self.cfg, self.passes * self.b, seed, device)

    def reference(self, frames: np.ndarray, quant=ref_model.identity):
        """The MC reference's answers to ``frames``, a request of the pool,
        as numpy.  A pool slot's answers are computed once a ``quant``: the
        masks are the same for every request."""
        key = (frames.__array_interface__["data"][0], len(frames), quant)
        if key in self._refs:
            return self._refs[key]
        dev, blk, p = self.device, self.tr["check_block"], self.params
        outs = []
        with torch.no_grad(), no_tf32():
            masks = self.masks(dev)
            for a in range(0, len(frames), blk):
                x = torch.as_tensor(frames[a:a + blk]).to(dev)
                rows = range(a, a + len(x))
                outs.append([t.cpu().double().numpy() for t in
                             ref_mc.serve(p, x, self.cfg, masks, self.passes, self.b, rows,
                                          quant=quant)])
        self._refs[key] = [np.concatenate(parts) for parts in zip(*outs)]
        return self._refs[key]
