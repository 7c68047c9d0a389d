"""Readings that set the MC-dropout cells' check limits, with the faults of
their masks (``calibrate.py`` has the other cells').

    python3 benchmark/calibrate_mc.py --workload mc_predict_b32 --seeds 12 \
        [--first-seed <n>] [--controls 3] [--faults 3] [--out <dir>]

In one process, for each seed: the program's readings as a run takes them
(its set-up and a pool of requests, against the MC reference with the same
masks); on the first ``--controls`` seeds the fp8 control's (the reference
in fp8, ``reference/quant.py``, in the program's place); on the first
``--faults`` seeds the readings of the program serving the same requests
with each fault of ``FAULTS``:

* ``dead_masks``: every keep mask the program draws is all True (each live
  site scales by 1 / keep and drops nothing);
* ``wrong_seed``: ``predict`` folds its masks from another seed (the
  call's seed + 1), so each site drops other channels.

Each reading is a JSON line on standard output and in
``<out>/calibrate_<cell>.jsonl``, as ``calibrate.py`` writes them.  Needs
the card; no window is measured.
"""

from __future__ import annotations

import contextlib
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import calibrate  # noqa: E402


@contextlib.contextmanager
def dead_masks():
    """The program's every keep mask all True."""
    from benchmark.reference.mc import dead_masks as keep_all
    from mimo_unet_torch.ops.dropout import DropoutSource

    orig = DropoutSource.draw
    DropoutSource.draw = lambda self, sites, device: keep_all(orig(self, sites, device))
    try:
        yield
    finally:
        DropoutSource.draw = orig


@contextlib.contextmanager
def wrong_seed():
    """``predict`` folds its masks from the call's seed + 1."""
    from mimo_unet_torch.models.ensemble import Ensemble

    orig = Ensemble.predict

    def predict(self, images, batch_size=32, device=None, seed=0):
        return orig(self, images, batch_size=batch_size, device=device, seed=seed + 1)

    Ensemble.predict = predict
    try:
        yield
    finally:
        Ensemble.predict = orig


FAULTS = {"dead_masks": dead_masks, "wrong_seed": wrong_seed}


def mc_readings(cls, cell, seed, device, control, fault):
    from benchmark.reference.quant import fp8

    d = cls(cell.config, cell.traffic, seed, device)
    d.setup()
    for _ in range(cell.traffic["pool_requests"]):
        d.step()
    faulted = {}
    if fault:
        for name, ctx in FAULTS.items():
            with ctx():
                faulted[name] = [(r, d._request(r)) for r, _ in d.kept]
    d.release()
    calibrate.free(device)
    out = [("program", d.readings())]
    if control:
        out.append(("control_fp8", d.worst([d.judge(d.reference(d._frames(r), quant=fp8),
                                                    d._frames(r)) for r, _ in d.kept])))
    for name, kept in faulted.items():
        out.append((f"fault_{name}", d.worst([d.judge(a, d._frames(r)) for r, a in kept])))
    return out


def main(argv=None) -> int:
    """``calibrate.py``'s command, its serve readings the MC cells'."""
    orig = calibrate.serve_readings
    calibrate.serve_readings = mc_readings
    try:
        return calibrate.main(argv)
    finally:
        calibrate.serve_readings = orig


if __name__ == "__main__":
    sys.exit(main())
