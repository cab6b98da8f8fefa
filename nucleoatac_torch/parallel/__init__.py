"""Multi-process runs of the port: one process per host or per GPU."""
