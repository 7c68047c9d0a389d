"""Driver of ``Ensemble.predict``: one caller sending back-to-back requests
(a closed loop), each ``request_frames`` distinct float32 frames in one
``predict`` call of that ``batch_size``, cycled from a pool of
``pool_requests`` requests made at set-up.

The member is the configuration's model in eval mode, its weights drawn
from the seed and its BatchNorm statistics set by the reference over
seeded frames (``inputs.py``).  Each request is timed on the
host clock from the call to its numpy answers (``predict`` returns only
once they are on the host).

Check: a sample of ``checked_requests`` of the window's requests, drawn
from the seed, keeps its answers; once the window has closed the float32
reference serves the same frames, in blocks of ``check_block`` rows, and
each frame's mean, aleatoric and epistemic variance are compared by their
relative RMS gap (norm of the difference over the reference's norm):
``mean_gap``, ``aleatoric_gap`` and ``epistemic_gap`` the worst frame's,
``*_req`` the worst request's.  How far rounding moves the answers of a
random network differs several-fold from seed to seed, so the numbers
compared are each request's gaps in units of the gaps that the reference
rounded to bfloat16, the configurations' precision, gives on the same
frames: ``*_vs_bf16``, the worst request's, and ``*_frame_vs_bf16``, the
worst frame's (a frame answered wrongly is diluted in its request's gap,
not in its own).
"""

from __future__ import annotations

import math
import random
import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import inputs
from benchmark.drivers.common import make_task, no_tf32, synchronize
from benchmark.reference import model as ref_model, train as ref_train
from benchmark.reference.quant import bf16

REQUEST = "bench.request"
NAMES = ("mean_gap", "aleatoric_gap", "epistemic_gap")


class Driver:
    kind = "serve"
    reference_setup_s = 0.0

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.cfg, self.tr, self.seed, self.device = config, traffic, seed, device
        self.latencies = []

    def setup(self) -> None:
        from mimo_unet_torch.models.ensemble import Ensemble

        cfg, tr, dev = self.cfg, self.tr, self.device
        self.b = tr["request_frames"]
        task = make_task(cfg, self.seed)
        model = task.build_model(device=dev)
        # the benchmark's weights, kept for the reference (the model holds a copy)
        self.params = inputs.weights(cfg, self.seed, dev, serving=True)
        # the reference's float32 pass that sets the BatchNorm statistics is
        # not the program's set-up: run.py takes its time out of setup_s
        synchronize(dev)
        t0 = time.perf_counter()
        with no_tf32():
            inputs.set_statistics(self.params, cfg, self.seed, dev, tr["height"], tr["width"])
        synchronize(dev)
        self.reference_setup_s = time.perf_counter() - t0
        model.load_state_dict(self.params)
        if torch.device(dev).type == "cuda":
            # the peak of the reference's float32 calibration pass is not the program's
            torch.cuda.reset_peak_memory_stats(dev)
        self.ensemble = Ensemble([(task, model)])
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

    def _frames(self, r: int) -> np.ndarray:
        k = r % self.tr["pool_requests"]
        return self.pool[k * self.b:(k + 1) * self.b]

    def _request(self, r: int):
        return self.ensemble.predict(self._frames(r), batch_size=self.b)

    def step(self) -> None:
        r = len(self.latencies)
        t0 = time.perf_counter()
        with record_function(REQUEST):
            answers = self._request(r)
        self.latencies.append(time.perf_counter() - t0)
        # reservoir sample of the window's requests
        m = self.tr["checked_requests"]
        if len(self.kept) < m:
            self.kept.append((r, answers))
        else:
            j = self.sample.randrange(r + 1)
            if j < m:
                self.kept[j] = (r, answers)

    def counts(self) -> dict:
        n = len(self.latencies)
        return {"requests": n, "frames": n * self.b}

    def end_to_end(self, elapsed: float) -> dict:
        lat = sorted(self.latencies)
        p95 = lat[min(len(lat) - 1, int(np.ceil(0.95 * len(lat))) - 1)]
        return {"serve_frames_per_s": len(lat) * self.b / elapsed,
                "serve_latency_p95_ms": 1e3 * p95}

    def window_parts(self) -> dict:
        """frames/s and mean latency of each third of the window's requests:
        how far a run's own rate wanders, against the spread between runs."""
        lat, n = self.latencies, len(self.latencies)
        cuts = [round(i * n / 3) for i in range(4)]
        chunks = [lat[a:b] for a, b in zip(cuts, cuts[1:]) if b > a]
        return {"frames_per_s": [len(c) * self.b / sum(c) for c in chunks],
                "mean_ms": [1e3 * sum(c) / len(c) for c in chunks]}

    def release(self) -> None:
        del self.ensemble

    def reference(self, frames: np.ndarray, quant=ref_model.identity):
        """The reference's answers to ``frames``, as numpy."""
        dev, blk, p = self.device, self.tr["check_block"], self.params
        outs = []
        with torch.no_grad(), no_tf32():
            for a in range(0, len(frames), blk):
                x = torch.as_tensor(frames[a:a + blk]).to(dev)
                outs.append([t.cpu().double().numpy()
                             for t in ref_train.serve(p, x, self.cfg, quant=quant)])
        return [np.concatenate(parts) for parts in zip(*outs)]

    @staticmethod
    def gaps(answers, ref) -> dict:
        """Per answer, frame by frame: the RMS gap to the reference and the
        reference's norm."""
        out = {}
        for name, a, r in zip(NAMES, answers, ref):
            a = np.asarray(a, dtype=np.float64).reshape(len(r), -1)
            r = r.reshape(len(r), -1)
            out[name] = (np.linalg.norm(a - r, axis=1), np.linalg.norm(r, axis=1))
        return out

    def judge(self, answers, frames: np.ndarray) -> dict:
        """The readings of ``answers`` to ``frames``: their relative gaps to
        the reference, and their gaps over the bf16-rounded reference's, over
        the request and frame by frame."""
        ref = self.reference(frames)
        prog, unit = self.gaps(answers, ref), self.gaps(self.reference(frames, quant=bf16), ref)
        got = {}
        for name in NAMES:
            (gap, norm), (unit_gap, _) = prog[name], unit[name]
            short = name[:-len("_gap")]
            got[name] = float((gap / norm).max())
            got[name + "_req"] = float(np.linalg.norm(gap) / np.linalg.norm(norm))
            got[short + "_vs_bf16"] = float(np.linalg.norm(gap) / np.linalg.norm(unit_gap))
            got[short + "_frame_vs_bf16"] = float((gap / unit_gap).max())
        return got

    @staticmethod
    def worst(readings) -> dict:
        """Each reading's worst over requests; one that is not finite stays."""
        return {k: (max(r[k] for r in readings)
                    if all(math.isfinite(r[k]) for r in readings) else math.inf)
                for k in readings[0]}

    def readings(self) -> dict:
        return self.worst([self.judge(answers, self._frames(r)) for r, answers in self.kept])
