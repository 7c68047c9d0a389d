"""One driver per entry point that a window drives."""
