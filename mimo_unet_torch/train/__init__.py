"""Training harness of the port: optimizer and schedule, trainer,
checkpoints, the remat capacity ladder, profiling and logging."""
