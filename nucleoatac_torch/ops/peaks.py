"""Peak calling as batched torch ops: local maxima + greedy non-overlap
selection.

Counterpart of nucleoatac_tpu/ops/peaks.py, with its semantics (shared
with mirror.local_max_candidates / greedy_select): a position is a
candidate iff it is strictly greater than every value in the preceding
``halfwin`` positions and >= every value in the following ``halfwin``
(leftmost of a plateau); greedy selection repeatedly takes the
highest-scoring candidate (ties -> leftmost) and suppresses |d| < sep, a
fixed number of rounds, returning a padded [B, max_calls] position list
with a validity mask. No stage calls these: both packages select peaks on
the host (utils/numerics.py).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

_NEG = -3.0e38  # float32 "minus infinity" of the reference


def _window_max(x: torch.Tensor, win: int, side: str) -> torch.Tensor:
    """Per-position max over the ``win`` strictly-left or strictly-right
    neighbours of [B, W] rows (excluding self); _NEG beyond bounds."""
    if side == "left":
        xp = torch.nn.functional.pad(x, (win, 0), value=_NEG)[:, :-1]
    else:
        xp = torch.nn.functional.pad(x, (0, win), value=_NEG)[:, 1:]
    return xp.unfold(1, win, 1).amax(dim=-1)


def local_max_batch(x: torch.Tensor, halfwin: int, mask: torch.Tensor) -> torch.Tensor:
    """x: [B, W] scores; mask: [B, W] bool. Returns bool [B, W] candidates."""
    lm = _window_max(x, halfwin, "left")
    rm = _window_max(x, halfwin, "right")
    return mask & (x > lm) & (x >= rm)


class GreedyOut(NamedTuple):
    positions: torch.Tensor  # [B, max_calls] int32, ascending among valid
    valid: torch.Tensor  # [B, max_calls] bool


def greedy_select_batch(
    scores: torch.Tensor,  # [B, W]
    candidates: torch.Tensor,  # [B, W] bool
    sep: int,
    max_calls: int,
) -> GreedyOut:
    B, W = scores.shape
    pos_idx = torch.arange(W, device=scores.device)[None, :]
    live = torch.where(candidates, scores, _NEG)
    ps, oks = [], []
    for _ in range(max_calls):
        p = torch.argmax(live, dim=1)  # first index on ties
        val = torch.gather(live, 1, p[:, None])[:, 0]
        oks.append(val > _NEG / 2)
        ps.append(p)
        live = torch.where((pos_idx - p[:, None]).abs() < sep, _NEG, live)
    positions = torch.stack(ps, dim=1).to(torch.int32)
    valid = torch.stack(oks, dim=1)
    # ascending by position, invalid entries pushed to the end (stable, as
    # the reference's argsort)
    key = torch.where(valid, positions, W + 1)
    order = torch.argsort(key, dim=1, stable=True)
    return GreedyOut(torch.gather(positions, 1, order), torch.gather(valid, 1, order))
