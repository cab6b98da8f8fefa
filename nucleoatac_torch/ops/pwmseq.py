"""Tn5 PWM bias scoring from sequence codes.

Counterpart of nucleoatac_tpu/ops/pwmseq.py: per-bp log bias
``B[p] = sum_l log_ratio[code(p + l), l]`` over the window's context, with
codes >= 4 (N / out-of-genome) contributing 0. Written as an unfold of the
code row plus a gather-and-sum over the [4, L] table — exact products
(one-hot weights), float32 sums, no cuDNN convolution.
"""
from __future__ import annotations

import torch


def unpack_nibble_codes(packed: torch.Tensor, wp: int) -> torch.Tensor:
    """[B, ceil(wp/2)] uint8, two 4-bit codes per byte (low nibble first)
    -> [B, wp] codes."""
    codes = torch.stack([packed & 0xF, packed >> 4], dim=-1)
    return codes.reshape(packed.shape[0], -1)[:, :wp]


def unpack_2bit_codes(packed: torch.Tensor, wp: int, esc: torch.Tensor) -> torch.Tensor:
    """[B, ceil(wp/4)] uint8 2-bit codes (4 per byte, little-endian) + [E, 2]
    (row, col) N-position escapes -> [B, wp] codes (wire v9). Padded escape
    entries target the dead column wp of a width-(wp+1) scratch."""
    parts = [(packed >> (2 * k)) & 3 for k in range(4)]
    codes = torch.stack(parts, dim=-1).reshape(packed.shape[0], -1)[:, :wp]
    ext = torch.cat(
        [codes, torch.zeros((codes.shape[0], 1), dtype=codes.dtype, device=codes.device)],
        dim=1,
    )
    esc = esc.long()
    # the 4 is made on the codes' device, so that the scatter copies
    # nothing from the host (a CUDA graph capture admits no host copy)
    ext.index_put_((esc[:, 0], esc[:, 1]), ext.new_full((), 4))
    return ext[:, :wp]


def pwm_bias_batch(codes: torch.Tensor, log_ratio: torch.Tensor) -> torch.Tensor:
    """codes: [B, W + L - 1] uint8; log_ratio: [4, L] f32 -> [B, W] f32.

    Output position p scores the context codes[p : p + L]."""
    L = log_ratio.shape[1]
    table = torch.cat(
        [log_ratio.to(torch.float32),
         torch.zeros((1, L), dtype=torch.float32, device=log_ratio.device)]
    )  # row 4: N / out-of-genome -> 0
    ctx = torch.clamp(codes.long(), max=4).unfold(1, L, 1)  # [B, W, L]
    col = torch.arange(L, device=codes.device)
    return table[ctx, col].sum(dim=-1)

