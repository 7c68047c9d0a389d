"""Evaluation scripts and the latency probe (reference scripts/test/*.py)."""
