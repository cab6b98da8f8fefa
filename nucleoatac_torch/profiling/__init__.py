"""Profilers of the port: the device chain stage by stage (stages.py) and
the host finishing of the fused pass under cProfile (finish.py)."""
