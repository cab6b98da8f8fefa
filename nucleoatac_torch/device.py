"""Explicit device resolution and float32 precision settings.

The reference runs the matmul-shaped stages at HIGH or HIGHEST precision
(DESIGN.md §10). PyTorch's defaults would let cuDNN convolutions run in
TF32 (10-bit mantissa), which silently breaks the f64-certification
tolerances (``cfg.occ.exact_tol``, ``cfg.nuc.exact_tol``), so every
resolved device also pins full-f32 matmul and convolution precision.
"""
from __future__ import annotations

import numpy as np
import torch


def set_precision_flags() -> None:
    """Full float32 for matmuls and cuDNN convolutions (idempotent)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises rather than falling back.

    ``"cuda"`` without an available card is an error: the CPU path runs
    only when the caller asks for ``"cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain CPU path"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    set_precision_flags()
    return dev


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on ``device``; CUDA uploads go from pinned
    memory without blocking the host."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)
