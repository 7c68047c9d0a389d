"""Training pieces of the port (optimizer and schedule)."""
