"""Start N ranks on this host without a launcher.

``spawn(fn, n, args)`` starts ``n`` processes with the ``spawn`` start
method (CUDA needs it), makes each a rank of one process group
(``initialize_multihost`` over a file store in a fresh temporary
directory) and runs ``fn(*args)`` in each, then stops the group.  The
backend follows the device: NCCL where every rank has a card of its own,
gloo where the ranks share one card or run on the CPU.  The call returns
when every rank has returned; it raises, stopping the others, when one
rank fails, and when ``timeout`` seconds pass first.  ``torchrun`` does
the same across hosts; the train scripts' ``--num_devices N`` uses this
when no launcher started them (``cli.run_training``).
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from typing import Callable, Optional, Sequence

import torch


def backend_for(device, nprocs: int) -> str:
    """NCCL when each of ``nprocs`` ranks of this host has a card of its own,
    else gloo (ranks sharing a card, or on the CPU)."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.device_count() >= nprocs:
        return "nccl"
    return "gloo"


def _rank_main(rank: int, fn: Callable, nprocs: int, init_method: str, backend: str,
               args: Sequence) -> None:
    import torch.distributed as dist

    from mimo_unet_torch.parallel.multihost import initialize_multihost

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(nprocs),
                      LOCAL_WORLD_SIZE=str(nprocs))
    initialize_multihost(init_method, nprocs, rank, backend)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, args: Sequence = (), *, device=None,
          timeout: Optional[float] = None) -> None:
    """Run ``fn(*args)`` in ``nprocs`` new processes, one rank each (see the
    module docstring); ``device`` is the ranks' device as ``Trainer`` takes
    it (a card with its index: one card they share).  ``fn`` must be a
    module-level function; ``args`` are pickled to each process."""
    import torch.multiprocessing as mp

    backend = backend_for(device, nprocs)
    tmp = tempfile.mkdtemp(prefix="mimo_ranks_")
    init_method = "file://" + os.path.join(tmp, "store")
    ctx = mp.start_processes(_rank_main, args=(fn, nprocs, init_method, backend, tuple(args)),
                             nprocs=nprocs, join=False, start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{nprocs} ranks of {getattr(fn, '__name__', fn)} "
                                   f"did not end within {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
        for p in ctx.processes:
            p.join(10)
            if p.is_alive():
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)
