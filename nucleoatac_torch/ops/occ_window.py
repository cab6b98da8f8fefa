"""K3: the occupancy window sums, picks and wire-v8 pack in one launch.

From the LL projection ([B, G, W], the SGEMM of ops/occupancy.py ::
occupancy_packed2) and the column counts ([B, W]), one launch of
csrc/occ_window.cu sums each core position's window directly in float64,
rounds once to float32, takes the picks of ``_picks`` and writes the
wire-v8 bytes. It replaces no TPU kernel: the reference leaves these steps
to XLA. The plain version is ``packed2_from_proj`` (ops/occupancy.py), the
torch form of the same steps. The kernel has no CPU mode: on any other
device the wrapper raises, and occupancy_packed2 runs its torch code there.
"""
from __future__ import annotations

import torch

from nucleoatac_torch.kernels import load_library, stream_handle

# kernel launches made by occ_window
LAUNCHES = 0

# the largest grid the 7-bit grid index of wire v8 holds
MAX_GRID = 128


def occ_window(
    proj: torch.Tensor,  # [B, G, W] float32, any strides
    counts: torch.Tensor,  # [B, W] float32, columns contiguous
    flank: int,
    core_lo: int,
    core_len: int,
    ci_drop: float,
    exact_tol: float,
) -> torch.Tensor:
    """Wire-v8 occ bytes, uint8 [B, 2*core_len + ceil(core_len/4)], of
    occupancy_packed2 from its projection and column counts. ``ci_drop``
    and ``exact_tol`` reach the kernel as float32, the values torch's
    scalar promotion compares a float32 surface with."""
    global LAUNCHES
    B, G, W = proj.shape
    if G > MAX_GRID:
        raise ValueError(
            f"grid size {G} > {MAX_GRID} overflows the 7-bit packed grid index"
        )
    for name, t in (("proj", proj), ("counts", counts)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if proj.device.type != "cuda" or counts.device != proj.device:
        raise ValueError(f"occ_window: proj on {proj.device} and counts on "
                         f"{counts.device}; the kernel takes one CUDA device")
    if tuple(counts.shape) != (B, W) or (W > 1 and counts.stride(1) != 1):
        raise ValueError(f"counts has shape {tuple(counts.shape)} and strides "
                         f"{counts.stride()}, expected ({B}, {W}) with columns contiguous")
    if flank < 0 or core_len < 0 or G < 1:
        raise ValueError(f"flank {flank}, core_len {core_len}, grid {G}")
    out = torch.empty((B, 2 * core_len + -(-core_len // 4)), dtype=torch.uint8,
                      device=proj.device)
    if B == 0 or core_len == 0:
        return out
    lib = load_library()
    with torch.cuda.device(proj.device):
        rc = lib.nucleoatac_occ_window(
            proj.data_ptr(), *proj.stride(), counts.data_ptr(), counts.stride(0),
            out.data_ptr(), B, G, W, flank, core_lo, core_len, ci_drop, exact_tol,
            stream_handle(proj.device),
        )
    if rc != 0:
        raise RuntimeError(f"occ_window kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out
