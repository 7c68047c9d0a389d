"""Phase 20 of chip_smoke.py alone: the spatial (H) split on a 1x2 mesh of
two gloo ranks sharing the card, the flagship at full width on 640x480
frames.  The phase launches no hand-written kernel, so nothing is built.

    python3 tools/spatial_phase.py

Run from the root of the repository; ~1 min on the H100.
"""
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402

if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("tools/spatial_phase.py: CUDA is not available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    C.spatial_split(dev, card)
    print(f"DONE {time.perf_counter() - t0:.1f} s")
