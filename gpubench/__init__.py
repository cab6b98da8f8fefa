"""The benchmark of nucleoatac_torch (see gpubench/run.py)."""
