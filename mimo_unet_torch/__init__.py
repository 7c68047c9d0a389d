"""PyTorch + CUDA port of mimo_unet_tpu for NVIDIA Hopper (H100).

The JAX package ``mimo_unet_tpu`` is the reference; this package mirrors its
module names.  It imports torch and numpy, never jax.  This slice holds the
eval/serving path: the plain model, the kernel path of
``models/fast_path.py`` with the hand-written kernels of ``kernels/``
(sources in ``csrc/``), the losses, the task's forward and val step, and
the ensemble.
"""
