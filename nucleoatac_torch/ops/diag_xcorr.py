"""K1: template cross-correlation of one input with two 2-D kernels.

Counterpart of nucleoatac_tpu/ops/pallas_diag.py (``diag_conv_pallas``,
``nuc_conv_outputs_pallas``). On a CUDA tensor the wrapper launches the
hand-written kernel of csrc/diag_xcorr.cu; on a CPU tensor it runs the
plain version (ops/xcorr.py :: conv_stack_diag). It never falls back.
"""
from __future__ import annotations

import torch

from nucleoatac_torch.kernels import check_cuda_f32, load_library, stream_handle
from nucleoatac_torch.ops.xcorr import conv1d_stack, conv_stack_diag

# kernel launches made by diag_xcorr (plain CPU calls are not counted)
LAUNCHES = 0


def diag_xcorr(x: torch.Tensor, k2d: torch.Tensor) -> torch.Tensor:
    """x [B, S, W] (x) k2d [C, K, S] -> [B, C, W-K+1] valid xcorr.

    The kernel takes C == 2 (the shape of every stack on the nuc path)
    and float32 inputs whose rows are contiguous."""
    global LAUNCHES
    if x.device.type == "cpu":
        return conv_stack_diag(x, k2d)
    if x.device.type != "cuda":
        raise ValueError(f"diag_xcorr: unsupported device {x.device}")
    B, S, W = x.shape
    C, K = k2d.shape[0], k2d.shape[1]
    if C != 2:
        raise ValueError(f"diag_xcorr kernel takes 2 channels, got {C}")
    if K > W:
        raise ValueError(f"kernel width {K} exceeds input width {W}")
    check_cuda_f32("x", x, (B, S, W), x.device, batch_strided=True)
    check_cuda_f32("k2d", k2d, (2, K, S), x.device)
    out = torch.empty((B, 2, W - K + 1), dtype=torch.float32, device=x.device)
    if B == 0:
        return out
    lib = load_library()
    # the launch and its shared-memory attribute go to x's card, whatever
    # the process's current device is
    with torch.cuda.device(x.device):
        rc = lib.nucleoatac_diag_xcorr(
            x.data_ptr(), x.stride(0), k2d.data_ptr(), out.data_ptr(),
            B, S, W, K, stream_handle(x.device),
        )
    if rc != 0:
        raise RuntimeError(f"diag_xcorr kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out


def nuc_conv_outputs(frag_mat, b0, f2d, f1d, b2d, b1d):
    """Counterpart of nuc_conv_outputs_pallas: the 2-D stacks through
    diag_xcorr, the rank-1 reductions as 1-D convolutions of the column
    sums. Returns (fo [B, 5, W-K+1], bo [B, 3, W-K+1]) in the channel
    order of ops/xcorr.py :: nuc_conv_outputs_diag."""
    f2 = diag_xcorr(frag_mat, f2d)
    b2 = diag_xcorr(b0, b2d)
    f1 = conv1d_stack(frag_mat.sum(dim=1), f1d)
    b1 = conv1d_stack(b0.sum(dim=1), b1d)
    fo = torch.cat([f2[:, :1], f1[:, :1], f2[:, 1:2], f1[:, 1:3]], dim=1)
    bo = torch.cat([b1, b2], dim=1)
    return fo, bo
