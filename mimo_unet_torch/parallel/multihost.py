"""Process-group start-up and each process's share of a global batch.

Counterpart of ``mimo_unet_tpu/parallel/multihost.py``: where the JAX
package calls ``jax.distributed.initialize`` before ``make_mesh``, the
port starts a ``torch.distributed`` process group, one process a card:

    from mimo_unet_torch.parallel.multihost import initialize_multihost
    initialize_multihost()      # under torchrun: reads its environment
    mesh = make_mesh()          # spans every rank

``host_local_batch_slice`` gives the [start, stop) of the global batch
this process owns.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional, Tuple

import torch

# a collective that one rank never reaches raises after this long instead
# of hanging; it also bounds rank 0's first kernel build, which the others
# wait for at a barrier (kernels/_build.py ``load_library``)
DEFAULT_TIMEOUT_S = 900.0


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Start this process's ``torch.distributed`` process group.

    Rank and world size come from the arguments, else from torchrun's
    environment (``RANK``, ``WORLD_SIZE``; the address from
    ``MASTER_ADDR``/``MASTER_PORT``).  ``coordinator_address`` is
    ``host:port`` (TCP) or an ``init_method`` URL such as
    ``file:///path``.  With neither arguments nor environment, or with a
    group already started, it does nothing, as the JAX function (:28-47).
    ``backend=None`` takes NCCL where CUDA is available and gloo on the CPU;
    ranks that share one card pass ``"gloo"`` (NCCL refuses two ranks on
    one device).  ``DEFAULT_TIMEOUT_S`` bounds every collective."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    env = os.environ
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if num_processes is None:
        return  # one process and no cluster environment
    if process_id is None:
        raise ValueError("initialize_multihost: num_processes without process_id "
                         "(or RANK)")
    if coordinator_address is None:
        if "MASTER_ADDR" not in env:
            raise ValueError("initialize_multihost: no coordinator_address and no "
                             "MASTER_ADDR/MASTER_PORT in the environment")
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        local = int(env.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=int(num_processes), rank=int(process_id),
                            timeout=timedelta(seconds=DEFAULT_TIMEOUT_S))


def host_local_batch_slice(global_batch: int) -> Tuple[int, int]:
    """[start, stop) of the global batch this process feeds (rank-major, as
    the JAX function's process-major device order, :50-61)."""
    import torch.distributed as dist

    init = dist.is_available() and dist.is_initialized()
    n_proc = dist.get_world_size() if init else 1
    if global_batch % n_proc:
        raise ValueError(
            f"global batch {global_batch} must be divisible by the process "
            f"count {n_proc}"
        )
    per = global_batch // n_proc
    start = (dist.get_rank() if init else 0) * per
    return start, start + per
