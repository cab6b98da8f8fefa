"""Gaussian smoothing kernel and batched smoothing (DESIGN.md §7).

Counterpart of nucleoatac_tpu/ops/smooth.py: a normalized gaussian of
halfwidth round(3*sd), identical to mirror.gauss_smooth's, and its
zero-padded 'same' convolution over [B, W] rows.
"""
from __future__ import annotations

import numpy as np
import torch


def gauss_kernel(sd: float) -> np.ndarray:
    if sd <= 0:
        return np.array([1.0], dtype=np.float32)
    hw = max(1, int(round(3 * sd)))
    t = np.arange(-hw, hw + 1, dtype=np.float64)
    k = np.exp(-0.5 * (t / sd) ** 2)
    return (k / k.sum()).astype(np.float32)


def gauss_smooth_batch(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """x: [B, W]; kernel: [K] (odd), on x's device. Returns [B, W].

    The zero-padded 'same' cross-correlation with the flipped kernel (as
    the reference flips it; a no-op for a gaussian): products and the sum
    over the taps in float64, rounded once to x's dtype, so a row's bits
    do not depend on how many rows the call holds. As a float32
    ``conv1d`` they did: one window alone and the same window in a batch
    of eight gave other bits on the CPU, so a sharded step's smoothed
    track differed from one device's."""
    K = kernel.shape[0]
    win = torch.nn.functional.pad(x, (K // 2, K // 2)).unfold(1, K, 1).double()
    return (win * kernel.flip(0).double()).sum(dim=-1).to(x.dtype)
