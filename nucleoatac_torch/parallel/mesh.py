"""The devices of a process, the sharded fused step and the one collective
reduction.

Counterpart of nucleoatac_tpu/parallel/mesh.py and of
nucleoatac_tpu/models/pipeline.py :: auto_mesh. The reference shards each
window batch over a 1-D ('data',) mesh of every local device
(``make_mesh``, ``auto_mesh``); here ``auto_devices`` picks the devices
and TorchEngine (models/engine.py) cuts each batch into one contiguous
slice per device. A rank of a ``torchrun`` group keeps its one card
(``local_device``). The genome-wide fragment-size histogram stays the
collective: a bincount on the device, summed across the process group.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Union

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


def local_devices(n: Optional[int] = None) -> List[torch.device]:
    """The first ``n`` (default: every) visible CUDA devices, in order:
    the counterpart of make_mesh's device list."""
    count = torch.cuda.device_count()
    return [torch.device("cuda", i) for i in range(count if n is None else min(n, count))]


def shard_count(device: str, visible: int, batch: int, in_group: bool) -> int:
    """The rule of auto_devices, on its inputs alone: the number of
    visible cards a window batch shards over, or 1 for the one device
    asked for. Every card when ``device`` is "cuda" without an index,
    more than one is visible, the batch divides among them and the
    process is not a rank of a torchrun group."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None and visible > 1 and not in_group \
            and batch % visible == 0:
        return visible
    return 1


def auto_devices(cfg, device: Union[str, torch.device, Sequence] = "cuda") -> List[torch.device]:
    """The devices one process shards its window batches over. A list
    names them (a device may repeat: two shards on one card); else
    shard_count's rule picks every visible card or the one device asked
    for: ``cuda:k`` that card alone, ``"cpu"`` the CPU, a torchrun rank
    ``cuda:{LOCAL_RANK}`` (local_device). Logs the choice, including a
    batch that does not divide over the visible cards."""
    import torch.distributed as dist

    from nucleoatac_torch.utils.logging import log

    B = cfg.window.batch
    if isinstance(device, (str, torch.device)):
        d = torch.device(device)
        # one rank of a launcher's group: LOCAL_RANK set (torchrun sets
        # it) or a live process group
        in_group = os.environ.get("LOCAL_RANK") is not None or (
            dist.is_available() and dist.is_initialized())
        visible = torch.cuda.device_count() if d.type == "cuda" else 0
        n = shard_count(str(d), visible, B, in_group)
        if n == 1:
            dev = local_device(device)
            if d.type == "cuda" and d.index is None and visible > 1 and not in_group:
                log.info("devices: %s alone: window batch %d does not divide "
                         "over %d visible cards", dev, B, visible)
            else:
                log.info("devices: %s", dev)
            return [dev]
        device = local_devices(n)
    devs = [resolve_device(x) for x in device]
    if not devs or B % len(devs):
        raise ValueError(f"window batch {B} does not divide over devices {devs}")
    log.info("devices: %d shards of %d windows on %s", len(devs), B // len(devs),
             ",".join(map(str, devs)))
    return devs


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


def sharded_full_step(engine):
    """The fused occ+nuc step with windows sharded over ``engine``'s
    devices: counterpart of the reference's sharded_full_step(engine,
    mesh), whose mesh is here the engine's device list (TorchEngine(...,
    device=[...]) or auto_devices). Returns ``(mids, sizes, valid,
    log_bias) -> (OccTracks, NucTracks)``: each device rasterizes and
    scores its contiguous slice of the windows with its own copy of the
    tables (replicated), and the tracks are gathered in window order on
    the first device. Arguments are [B, F] fragment lists and a [B, W]
    f32 log-bias row, host arrays or tensors; B must divide over the
    devices."""
    return engine.full_step_frags
