"""Plain PyTorch reference of the benchmarked system; imports nothing of the program."""
