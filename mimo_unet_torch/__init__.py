"""PyTorch + CUDA port of mimo_unet_tpu for NVIDIA Hopper (H100).

The JAX package ``mimo_unet_tpu`` is the reference; this package mirrors its
module names.  It imports torch and numpy, never jax.  It holds the plain
model, the eval and train kernel paths of ``models/fast_path.py`` with the
hand-written kernels of ``kernels/`` (sources in ``csrc/``), the losses,
the task's forward, train and val steps, the ensemble, and the training
harness (``train/``: trainer, checkpoints, the remat capacity ladder,
profiling, logging; ``data/core.py``: the host-fed pipeline).
"""
