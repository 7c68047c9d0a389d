"""Examples of the port's raw API."""
