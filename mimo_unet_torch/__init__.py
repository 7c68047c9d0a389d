"""PyTorch + CUDA port of mimo_unet_tpu for NVIDIA Hopper (H100).

The JAX package ``mimo_unet_tpu`` is the reference; this package mirrors its
module names.  It imports torch and numpy, never jax.  It holds the plain
model, the eval and train kernel paths of ``models/fast_path.py`` with the
hand-written kernels of ``kernels/`` (sources in ``csrc/``), the losses,
the MIMO and evidential tasks' forward, train and val steps, the ensemble,
the training harness (``train/``: trainer, checkpoints, reference
``.ckpt`` loading, the remat capacity ladder, profiling, logging;
``data/core.py``: the host-fed pipeline), the offline evaluation
(``eval/``: FGSM, predictions and uncertainty artifacts), and data
parallelism over several cards (``parallel/``: one process a card,
``torch.distributed``).
"""
