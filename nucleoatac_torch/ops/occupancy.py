"""Per-bp occupancy: alpha-grid MLE + likelihood-ratio CI.

Counterpart of nucleoatac_tpu/ops/occupancy.py: project the [B, S, W]
count matrix through the [S, G] log-mixture table with one full-float32
matmul, then sum each position's window of 2*flank+1 projections
DIRECTLY (an unfold of the zero-padded surface, summed) — not as a cumsum
difference, whose cancellation costs ~1e-2 absolute on LL ~1e2 in f32.
Tie rules follow the reference: argmax takes the first index; the CI's
last index is an argmax over the flipped surface. Three wire formats pack
the picks: v1 (occupancy_packed, whole window), v2 (occupancy_packed3,
core) and v8 (occupancy_packed2, core, CI bounds as deltas).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class OccOut(NamedTuple):
    occ: torch.Tensor  # [B, W]
    lower: torch.Tensor
    upper: torch.Tensor
    n: torch.Tensor  # fragment counts in window
    margin: torch.Tensor  # llmax - second-best LL
    ci_margin: torch.Tensor  # min_g |ll_g - (llmax - ci_drop)|


def _sliding_sum(x: torch.Tensor, flank: int) -> torch.Tensor:
    """Sum over the LAST axis in the window [p-flank, p+flank], zero
    outside bounds, summed directly per window (contiguous windows)."""
    xp = torch.nn.functional.pad(x, (flank, flank))
    return xp.unfold(-1, 2 * flank + 1, 1).sum(dim=-1)


def _ll_and_n(mat: torch.Tensor, log_mix: torch.Tensor, flank: int):
    """[B, W, G] window log-likelihood surface (a transposed view of a
    [B, G, W] tensor) + [B, W] window counts.

    The window sum accumulates in float64 and rounds once to the input
    dtype: a float32 running sum of 121 terms of |LL| ~ 2e3 drifted by
    1.03e-3 from float64 on the H100 at ~300 fragments per window, past
    occ.exact_tol (1e-3), which the certified flags rely on."""
    proj = torch.einsum("bsw,sg->bgw", mat, log_mix)
    ll = _sliding_sum(proj.double(), flank).to(proj.dtype).transpose(1, 2)
    n = _sliding_sum(mat.sum(dim=1), flank)
    return ll, n


def _picks(ll: torch.Tensor, ci_drop: float):
    """(best, first, last, llmax, margin, ci_margin) of [..., G] surfaces."""
    G = ll.shape[-1]
    best = torch.argmax(ll, dim=-1)  # first occurrence on ties
    llmax = torch.amax(ll, dim=-1)
    ok = (ll >= (llmax[..., None] - ci_drop)).to(torch.uint8)
    first = torch.argmax(ok, dim=-1)
    last = G - 1 - torch.argmax(torch.flip(ok, dims=(-1,)), dim=-1)
    is_best = torch.arange(G, device=ll.device) == best[..., None]
    ll2 = torch.amax(torch.where(is_best, -torch.inf, ll), dim=-1)
    margin = llmax - ll2
    thr = llmax[..., None] - ci_drop
    ci_margin = torch.amin(torch.abs(ll - thr), dim=-1)
    return best, first, last, llmax, margin, ci_margin


def occupancy_packed(
    mat: torch.Tensor,  # [B, S, W] float32 counts (integer-valued)
    log_mix: torch.Tensor,  # [S, G] float32
    flank: int,
    ci_drop: float = 1.92,
    exact_tol: float = 0.05,
) -> torch.Tensor:
    """Wire format v1: uint8 [B, 4, W] over the whole window.

    Channels: 0 = argmax grid index, 1 = CI-lower index, 2 = CI-upper
    index, 3 = certified flag (both LL margins clear ``exact_tol``, or
    the window is empty). An empty window reads (0, 0, G-1, 1)."""
    G = log_mix.shape[1]
    if G > 256:
        raise ValueError(
            f"grid size {G} > 256 overflows the uint8 grid-index wire format"
        )
    ll, n = _ll_and_n(mat, log_mix, flank)
    best, first, last, _, margin, ci_margin = _picks(ll, ci_drop)
    empty = n <= 0
    certified = ((margin > exact_tol) & (ci_margin > exact_tol)) | empty
    out = torch.stack(
        [torch.where(empty, 0, best), torch.where(empty, 0, first),
         torch.where(empty, G - 1, last), certified.long()],
        dim=1,
    )
    return out.to(torch.uint8)


def occupancy_packed3(
    mat: torch.Tensor,  # [B, S, W] float32 counts (integer-valued)
    log_mix: torch.Tensor,  # [S, G] float32
    flank: int,
    core_lo: int,
    core_len: int,
    ci_drop: float = 1.92,
    exact_tol: float = 0.05,
) -> torch.Tensor:
    """Wire format v2 (non-exact mode): uint8 [B, 3, core_len].

    Channels: 0 = argmax grid index | certified << 7, 1 = CI-lower index,
    2 = CI-upper index, over the window core [core_lo, core_lo +
    core_len). An empty window is certified and reads 0/0/G-1. There is
    no refinisher in this mode, so the CI bounds travel as full
    indices."""
    G = log_mix.shape[1]
    if G > 128:
        raise ValueError(
            f"grid size {G} > 128 overflows the 7-bit packed grid index"
        )
    ll, n = _ll_and_n(mat, log_mix, flank)
    ll = ll[:, core_lo : core_lo + core_len]
    n = n[:, core_lo : core_lo + core_len]
    best, first, last, _, margin, ci_margin = _picks(ll, ci_drop)
    empty = n <= 0
    certified = ((margin > exact_tol) & (ci_margin > exact_tol)) | empty
    ch0 = torch.where(empty, 0, best) | (certified.long() << 7)
    out = torch.stack(
        [ch0, torch.where(empty, 0, first), torch.where(empty, G - 1, last)],
        dim=1,
    )
    return out.to(torch.uint8)


def occupancy_packed2(
    mat: torch.Tensor,  # [B, S, W] float32 counts (integer-valued)
    log_mix: torch.Tensor,  # [S, G] float32
    flank: int,
    core_lo: int,
    core_len: int,
    ci_drop: float = 1.92,
    exact_tol: float = 0.05,
) -> torch.Tensor:
    """Wire format v8: uint8 [B, 2*core_len + ceil(core_len/4)].

    Bytes [0, core_len): argmax grid index | certified << 7; bytes
    [core_len, 2*core_len): low nibbles of the CI deltas (argmax - lower)
    | (upper - argmax) << 4; trailing ceil(core_len/4) bytes: each
    position's fifth delta bits, 2 bits per position (bit0 = lo_d bit 4,
    bit1 = up_d bit 4), 4 positions per byte, little-endian. A delta over
    31 or an empty window clears the certified flag and routes the
    position through the host float64 refinisher (models/occ.py)."""
    G = log_mix.shape[1]
    if G > 128:
        raise ValueError(
            f"grid size {G} > 128 overflows the 7-bit packed grid index"
        )
    ll, n = _ll_and_n(mat, log_mix, flank)
    ll = ll[:, core_lo : core_lo + core_len]
    n = n[:, core_lo : core_lo + core_len]
    best, first, last, _, margin, ci_margin = _picks(ll, ci_drop)
    lo_d = best - first
    up_d = last - best
    empty = n <= 0
    certified = (
        (margin > exact_tol)
        & (ci_margin > exact_tol)
        & (lo_d <= 31)
        & (up_d <= 31)
        & ~empty
    )
    ch0 = torch.where(empty, 0, best) | (certified.long() << 7)
    lo_c = torch.clamp(lo_d, max=31)
    up_c = torch.clamp(up_d, max=31)
    ch1 = torch.where(empty, 0, (lo_c & 0xF) | ((up_c & 0xF) << 4))
    hi2 = torch.where(empty, 0, (lo_c >> 4) | ((up_c >> 4) << 1))
    B = mat.shape[0]
    pad = (-core_len) % 4
    if pad:
        hi2 = torch.nn.functional.pad(hi2, (0, pad))
    h = hi2.reshape(B, -1, 4)
    hib = h[:, :, 0] | (h[:, :, 1] << 2) | (h[:, :, 2] << 4) | (h[:, :, 3] << 6)
    return torch.cat([ch0, ch1, hib], dim=1).to(torch.uint8)


def occupancy_batch(
    mat: torch.Tensor,  # [B, S, W] float32 counts (integer-valued)
    log_mix: torch.Tensor,  # [S, G] float32
    alpha_grid: torch.Tensor,  # [G] float32
    flank: int,
    ci_drop: float = 1.92,
) -> OccOut:
    """Float tracks over the whole window (tests and diagnostics)."""
    ll, n = _ll_and_n(mat, log_mix, flank)
    best, first, last, _, margin, ci_margin = _picks(ll, ci_drop)
    empty = n <= 0
    big = torch.finfo(torch.float32).max
    return OccOut(
        occ=torch.where(empty, 0.0, alpha_grid[best]),
        lower=torch.where(empty, 0.0, alpha_grid[first]),
        upper=torch.where(empty, 1.0, alpha_grid[last]),
        n=n,
        margin=torch.where(empty, big, margin),
        ci_margin=torch.where(empty, big, ci_margin),
    )
