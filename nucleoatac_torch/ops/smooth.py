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

    conv1d cross-correlates, so the kernel is flipped as the reference
    flips it (a no-op for a gaussian). The caller's device must carry
    device.py's precision flags: a TF32 convolution would move the
    smoothed track past nuc.exact_tol."""
    hw = kernel.shape[0] // 2
    out = torch.nn.functional.conv1d(
        x[:, None, :], kernel.flip(0)[None, None, :].to(x.dtype), padding=hw
    )
    return out[:, 0, :]
