"""One device per process, and the one collective reduction.

Counterpart of nucleoatac_tpu/parallel/mesh.py. The reference shards one
window batch over a 1-D device mesh inside one program (``make_mesh``,
``pipeline.auto_mesh``, ``sharded_full_step``); the PyTorch idiom is one
process per GPU over the shard path (models/distributed_pipeline.py),
so each process takes one device (``local_device``). The genome-wide
fragment-size histogram stays the collective: a bincount on the device,
summed across the process group.
"""
from __future__ import annotations

import os

import torch

from nucleoatac_torch.device import resolve_device


def local_device(device: str | torch.device = "cuda") -> torch.device:
    """This process's device: ``cuda:{LOCAL_RANK}`` when ``device`` is a
    CUDA device and LOCAL_RANK is set (as ``torchrun`` sets it), else
    ``device`` itself. Raises when LOCAL_RANK names a card this machine
    does not have (no silent wrap onto another card), and when CUDA is
    absent (resolve_device). Makes a CUDA device the current one."""
    dev = torch.device(device)
    local_rank = os.environ.get("LOCAL_RANK")
    if dev.type == "cuda" and local_rank is not None:
        idx = int(local_rank)
        n = torch.cuda.device_count()
        if not 0 <= idx < n:
            raise ValueError(
                f"LOCAL_RANK={idx} but this machine has {n} CUDA device(s); "
                "launch at most one process per GPU"
            )
        dev = torch.device("cuda", idx)
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def sharded_size_histogram(
    sizes: torch.Tensor, valid: torch.Tensor, lower: int, upper: int
) -> torch.Tensor:
    """Fragment-size histogram int64 [upper - lower] of ``sizes`` (any
    shape; the multi-host fit passes its shard's sizes flat) where
    ``valid`` and lower <= size < upper, on the tensors' device, summed
    over the live process group (the reference's psum over the mesh).
    The sum crosses gloo on the host: exact for integer counts."""
    import torch.distributed as dist

    keep = valid & (sizes >= lower) & (sizes < upper)
    hist = torch.bincount((sizes[keep] - lower).long(), minlength=upper - lower)
    if dist.is_available() and dist.is_initialized():
        host = hist.cpu()
        dist.all_reduce(host)
        hist = host.to(hist.device)
    return hist
