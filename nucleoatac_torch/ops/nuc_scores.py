"""K2: fused nuc scores from the fragment and bias matrices.

Counterpart of nucleoatac_tpu/ops/pallas_kernels.py (``nuc_scores_pallas``).
From F and B0 of a window batch, one launch of csrc/nuc_scores.cu computes
the eight footprint reductions, the score epilogue and the edge mask and
writes only [B, 5, W] = (norm, signal, lr, fuzz, n). On a CPU tensor the
wrapper runs the plain version (ops/xcorr.py); it never falls back.
"""
from __future__ import annotations

import torch

from nucleoatac_torch.kernels import check_cuda_f32, load_library, stream_handle
from nucleoatac_torch.ops.xcorr import finish_scores, nuc_conv_outputs_diag, pad_valid

# kernel launches made by nuc_scores (plain CPU calls are not counted)
LAUNCHES = 0

CHANNELS = ("norm", "signal", "lr", "fuzz", "n")


def nuc_scores_plain(frag_mat, b0, f2d, f1d, b2d, b1d, var_floor: float):
    """Plain PyTorch version of the kernel: [B, 5, W]."""
    W = frag_mat.shape[2]
    K = f2d.shape[1]
    fo, bo = nuc_conv_outputs_diag(frag_mat, b0, f2d, f1d, b2d, b1d)
    sc = finish_scores(pad_valid(fo, W, K), pad_valid(bo, W, K), var_floor)
    # zero-padded edges give n == 0 there, so every channel is already
    # masked to 0 outside the full-footprint positions
    return torch.stack([sc.norm, sc.signal, sc.lr, sc.fuzz, sc.n], dim=1)


def nuc_scores(
    frag_mat: torch.Tensor,  # [B, S, W] float32
    b0: torch.Tensor,  # [B, S, W] float32
    f2d: torch.Tensor,  # [2, K, S]
    f1d: torch.Tensor,  # [3, K]
    b2d: torch.Tensor,  # [2, K, S]
    b1d: torch.Tensor,  # [1, K]
    var_floor: float,
) -> torch.Tensor:
    """[B, 5, W] (norm, signal, lr, fuzz, n) with the edge mask applied.
    The tables are those of ops/xcorr.py :: build_kernels_diag."""
    global LAUNCHES
    if frag_mat.device.type == "cpu":
        return nuc_scores_plain(frag_mat, b0, f2d, f1d, b2d, b1d, var_floor)
    dev = frag_mat.device
    if dev.type != "cuda":
        raise ValueError(f"nuc_scores: unsupported device {dev}")
    B, S, W = frag_mat.shape
    K = f2d.shape[1]
    if K % 2 == 0 or K > W:
        raise ValueError(f"template width {K} must be odd and <= {W}")
    check_cuda_f32("frag_mat", frag_mat, (B, S, W), dev, batch_strided=True)
    check_cuda_f32("b0", b0, (B, S, W), dev, batch_strided=True)
    check_cuda_f32("f2d", f2d, (2, K, S), dev)
    check_cuda_f32("f1d", f1d, (3, K), dev)
    check_cuda_f32("b2d", b2d, (2, K, S), dev)
    check_cuda_f32("b1d", b1d, (1, K), dev)
    out = torch.empty((B, 5, W), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    lib = load_library()
    # the launch and its shared-memory attribute go to the tensors' card,
    # whatever the process's current device is
    with torch.cuda.device(dev):
        rc = lib.nucleoatac_nuc_scores(
            frag_mat.data_ptr(), frag_mat.stride(0), b0.data_ptr(), b0.stride(0),
            f2d.data_ptr(), f1d.data_ptr(), b2d.data_ptr(), b1d.data_ptr(),
            out.data_ptr(), B, S, W, K, float(var_floor), stream_handle(dev),
        )
    if rc != 0:
        raise RuntimeError(f"nuc_scores kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out


def stacks_to_diag(fk: torch.Tensor, bk: torch.Tensor):
    """build_kernels stacks (fk [5, S, K], bk [3, S, K]) -> the
    build_kernels_diag tables. Exact: the 2-D channels are transposed and
    the channels constant along S (fk 1/3/4, bk 0) are read from row 0 —
    raises if they are not constant."""
    for name, t, chans in (("fk", fk, (1, 3, 4)), ("bk", bk, (0,))):
        for c in chans:
            if not torch.equal(t[c], t[c, :1].expand_as(t[c])):
                raise ValueError(f"{name} channel {c} is not constant along S")
    f2d = torch.stack([fk[0].T, fk[2].T]).contiguous()
    f1d = torch.stack([fk[1, 0], fk[3, 0], fk[4, 0]]).contiguous()
    b2d = torch.stack([bk[1].T, bk[2].T]).contiguous()
    b1d = bk[0, :1].contiguous()
    return f2d, f1d, b2d, b1d


def nuc_scores_from_stacks(frag_mat, b0, fk, bk, var_floor: float = 1e-12):
    """nuc_scores with K2's own signature (the build_kernels stacks of
    nuc_scores_pallas): [B, 5, W] (norm, signal, lr, fuzz, n)."""
    return nuc_scores(frag_mat, b0, *stacks_to_diag(fk, bk), var_floor)
