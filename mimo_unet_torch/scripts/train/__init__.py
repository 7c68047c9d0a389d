"""Train scripts (reference scripts/train/*.py)."""
