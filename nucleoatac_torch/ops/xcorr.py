"""Template cross-correlation stack: signal/background/variance/LR/fuzz.

Plain PyTorch counterpart of nucleoatac_tpu/ops/xcorr.py. These are the
plain versions of the two CUDA kernels (ops/diag_xcorr.py,
ops/nuc_scores.py): the CPU path runs them, the kernel tests and
chip_smoke.py compare the kernels against them, and on a CUDA tensor
nothing on the main path calls them. The one library convolution is the
``conv="direct"`` route (conv_stack_direct), which the reference also
leaves to its compiler's convolution. It runs in full float32
(device.set_precision_flags); the stacks of the kernels' plain versions
sum in float64 and round once, so their bits do not depend on the batch
or the thread count.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class NucScoresOut(NamedTuple):
    signal: torch.Tensor  # [B, W]
    n: torch.Tensor
    exp_signal: torch.Tensor
    var: torch.Tensor
    norm: torch.Tensor
    lr: torch.Tensor
    fuzz: torch.Tensor


def build_kernels(vmat: np.ndarray, v_floor: float = 1e-5):
    """Host-side: stack conv kernels from the [S, K] template.

    F-side kernels (5): V, ones, log(max(V, floor)), offs, offs^2.
    B-side kernels (3): ones, V, V^2.
    Returned as float32 [out_ch, S, K] numpy arrays."""
    S, K = vmat.shape
    ones = np.ones((S, K))
    logv = np.log(np.maximum(vmat, v_floor))
    offs = np.broadcast_to((np.arange(K, dtype=np.float64) - K // 2)[None, :], (S, K))
    fk = np.stack([vmat, ones, logv, offs, offs * offs]).astype(np.float32)
    bk = np.stack([ones, vmat, vmat * vmat]).astype(np.float32)
    return fk, bk


def build_kernels_diag(vmat: np.ndarray, v_floor: float = 1e-5):
    """Kernel tables split by structure: the four reductions with genuine
    2-D structure (V and log V against the fragment matrix; V and V^2
    against the bias matrix) and the four constant along the size axis
    (ones, offs, offs^2 on fragments; ones on bias), which reduce to 1-D
    convolutions of the column sums. Returns (f2d [2, K, S], f1d [3, K],
    b2d [2, K, S], b1d [1, K]) float32 numpy arrays."""
    S, K = vmat.shape
    logv = np.log(np.maximum(vmat, v_floor))
    f2d = np.stack([vmat.T, logv.T]).astype(np.float32)  # [2, K, S]
    b2d = np.stack([vmat.T, (vmat * vmat).T]).astype(np.float32)
    offs = np.arange(K, dtype=np.float64) - K // 2
    f1d = np.stack([np.ones(K), offs, offs * offs]).astype(np.float32)
    b1d = np.ones((1, K), dtype=np.float32)
    return f2d, f1d, b2d, b1d


def _conv_stack(x: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    """[B, S, W] (x) [C, S, K] -> [B, C, W-K+1] valid cross-correlation,
    as one einsum over an unfold: the oracle of conv_stack_direct. It
    materialises [B, S, W-K+1, K] (about 7.6 GB at [64, 146, 1536] x 147
    taps), so it serves small inputs only."""
    K = kern.shape[2]
    return torch.einsum("bsjk,csk->bcj", x.unfold(2, K, 1), kern)


def conv_stack_direct(x: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    """[B, S, W] (x) [C, S, K] -> [B, C, W-K+1] valid cross-correlation as
    one ``conv1d`` with S input and C output channels: the route
    ``conv="direct"``, where the reference runs two XLA convolutions. In
    full float32 (``device.set_precision_flags`` turns cuDNN's TF32 off)."""
    return torch.nn.functional.conv1d(x, kern)


def nuc_conv_outputs_direct(frag_mat, b0, f_kernels, b_kernels):
    """(fo [B, 5, W-K+1], bo [B, 3, W-K+1]) as two direct convolutions
    over the build_kernels stacks, in the channel order of
    nuc_conv_outputs_diag."""
    return conv_stack_direct(frag_mat, f_kernels), conv_stack_direct(b0, b_kernels)


def conv_stack_diag(x: torch.Tensor, k2d: torch.Tensor) -> torch.Tensor:
    """[B, S, W] (x) [C, K, S] -> [B, C, W-K+1] valid xcorr: one batched
    matmul H[b, c*K+k, w] = sum_s k2d[c, k, s] x[b, s, w], then the sum of
    H's K diagonals read through a strided view (row k shifted by k).
    Products and sums in float64, rounded once to x's dtype: a float32
    GEMM's summation order is the BLAS library's choice, which may follow
    its shape (a shard's window count) or thread split, while the float64
    sums round to one float32 but at near-ties (relative error ~1e-14
    against f32's half-ulp of 6e-8)."""
    B, S, W = x.shape
    C, K, S2 = k2d.shape
    if S2 != S:
        raise ValueError(f"k2d size axis {S2} != x size axis {S}")
    Wo = W - K + 1
    H = torch.einsum("ks,bsw->bkw", k2d.reshape(C * K, S).double(),
                     x.double()).contiguous()
    diag = H.as_strided(
        (B, C, K, Wo), (C * K * W, K * W, W + 1, 1), H.storage_offset()
    )
    return diag.sum(dim=2).to(x.dtype)


def conv1d_stack(x: torch.Tensor, kerns: torch.Tensor) -> torch.Tensor:
    """[B, W] (x) [C, K] -> [B, C, W-K+1] valid xcorr of 1-D kernels
    against per-bp sums: products and a sum over the taps in float64,
    rounded once to x's dtype, so the bits do not depend on the thread
    count. Not a BLAS product: as a float32 einsum, the one-kernel stack
    (a matrix-vector product) gave six distinct results at 1 to 8 CPU
    threads, enough to move the u16 norm of equal inputs by a step."""
    K = kerns.shape[1]
    win = x.unfold(1, K, 1).double()  # [B, W-K+1, K]
    return (win[:, None] * kerns.double()[None, :, None, :]).sum(dim=-1).to(x.dtype)


def nuc_conv_outputs_diag(frag_mat, b0, f2d, f1d, b2d, b1d):
    """(fo [B, 5, W-K+1], bo [B, 3, W-K+1]) in the channel order
    (signal, n, flogv, foff, foff2) / (bsum, vb, v2b)."""
    f2 = conv_stack_diag(frag_mat, f2d)  # signal, flogv
    b2 = conv_stack_diag(b0, b2d)  # vb, v2b
    f1 = conv1d_stack(frag_mat.sum(dim=1), f1d)  # n, foff, foff2
    b1 = conv1d_stack(b0.sum(dim=1), b1d)  # bsum
    fo = torch.cat([f2[:, :1], f1[:, :1], f2[:, 1:2], f1[:, 1:3]], dim=1)
    bo = torch.cat([b1, b2], dim=1)
    return fo, bo


def pad_valid(t: torch.Tensor, W: int, K: int) -> torch.Tensor:
    """[B, C, W-K+1] valid outputs -> [B, C, W], dyad-aligned, zero edges."""
    half = K // 2
    return torch.nn.functional.pad(t, (half, W - half - (W - K + 1)))


def finish_scores(fo: torch.Tensor, bo: torch.Tensor, var_floor: float) -> NucScoresOut:
    """The elementwise epilogue over stacked conv outputs (the formulas of
    engine._finish_impl / the K2 epilogue)."""
    signal, n, flogv, foff, foff2 = (fo[:, i] for i in range(5))
    bsum, vb, v2b = (bo[:, i] for i in range(3))
    safe_b = torch.where(bsum > 0, bsum, 1.0)
    mu = vb / safe_b
    mu2 = v2b / safe_b
    exp_signal = n * mu
    var = n * (mu2 - mu * mu)
    ok = (var > var_floor) & (n > 0)
    norm = torch.where(
        ok, (signal - exp_signal) * torch.rsqrt(torch.where(ok, var, 1.0)), 0.0
    )
    lr = torch.where(n > 0, flogv - n * torch.log(torch.clamp(mu, min=1e-30)), 0.0)
    safe_n = torch.where(n > 0, n, 1.0)
    m1 = foff / safe_n
    m2 = foff2 / safe_n
    fuzz = torch.where(n > 0, torch.sqrt(torch.clamp(m2 - m1 * m1, min=0.0)), 0.0)
    return NucScoresOut(signal, n, exp_signal, var, norm, lr, fuzz)


def nuc_scores_batch(
    frag_mat: torch.Tensor,  # [B, S, W] float32
    b0: torch.Tensor,  # [B, S, W] float32
    f_kernels: torch.Tensor,  # [5, S, K]
    b_kernels: torch.Tensor,  # [3, S, K]
    var_floor: float = 1e-12,
) -> NucScoresOut:
    """All eight reductions as direct convolutions, then the epilogue."""
    K = f_kernels.shape[2]
    W = frag_mat.shape[2]
    fo = pad_valid(_conv_stack(frag_mat, f_kernels), W, K)
    bo = pad_valid(_conv_stack(b0, b_kernels), W, K)
    return finish_scores(fo, bo, var_floor)
