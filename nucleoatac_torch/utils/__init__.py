"""Host utilities of the port (logging and profiling)."""
