"""Peaks of the card and the work of a kernel, counted from shapes.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates at the 700 W
power limit: 495 TFLOP/s TF32 on the tensor cores, 67 TFLOP/s float32
outside them, 3.35 TB/s of HBM.

K2 (the template cross-correlation with its score epilogue) is counted as
the algorithm needs it, whatever implements it. Per valid dyad column
(W - K + 1 of them) and window: four sums with 2-D structure over the
template's S x K taps (fragments against V and log V, the bias matrix
against V and V^2), each a multiply and an add per tap; four sums constant
along the size axis (fragments against 1, offsets and their squares, the
bias matrix against 1), each 2 K operations on per-column sums, and the two
column sums themselves (S adds per column of each matrix). Bytes: each
input read once (the fragment and bias matrices [B, S, W] in float32, the
template tables, eight [K, S] or [K] rows) and each output written once
([B, 5, W] float32). The least time is the larger of the operations at the
TF32 peak and the bytes at HBM's rate.
"""
from __future__ import annotations

PEAKS = {
    "NVIDIA H100": {"tf32_flop_per_s": 495e12, "fp32_flop_per_s": 67e12,
                    "hbm_bytes_per_s": 3.35e12},
}


def peaks(kind: str) -> dict:
    for name, p in PEAKS.items():
        if kind.startswith(name):
            return p
    raise KeyError(f"no peaks for {kind!r}")


def k2_work(B: int, S: int, W: int, K: int):
    """(FLOPs, bytes) of one K2 launch over [B, S, W] matrices."""
    Wo = W - K + 1
    flops = 2.0 * B * Wo * (4 * S * K + 4 * K) + 2.0 * B * S * W
    nbytes = 4.0 * (2 * B * S * W + 4 * K * S + 4 * K + 5 * B * W)
    return flops, nbytes


def least_time(flops: float, nbytes: float, p: dict):
    """(seconds, "operations" or "bytes"): the larger quotient."""
    t_ops = flops / p["tf32_flop_per_s"]
    t_bytes = nbytes / p["hbm_bytes_per_s"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
