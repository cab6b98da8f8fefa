"""Sharded and multi-process runs of the port: one process over several
devices (parallel/mesh.py), and one process per host or per GPU
(parallel/distributed.py)."""
from nucleoatac_torch.parallel.mesh import (
    local_devices,
    sharded_full_step,
    sharded_size_histogram,
)

__all__ = ["local_devices", "sharded_full_step", "sharded_size_histogram"]
