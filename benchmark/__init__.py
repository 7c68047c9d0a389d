"""Benchmark of mimo_unet_torch (see benchmark/README.md)."""
