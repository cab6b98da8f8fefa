"""CPU float64 mirror of the device math — the correctness oracle.

Every function here implements DESIGN.md formulas in plain numpy float64
with obvious loops/vectorization. Device ops in ``nucleoatac_torch.ops`` are
tested against these (SURVEY.md §5: the rebuild's test pyramid layer (a)).
"""
from nucleoatac_torch.mirror.windows import (
    bias_mat,
    gauss_smooth,
    greedy_select,
    local_max_candidates,
    nuc_scores,
    occupancy_window,
    rasterize,
    sliding_counts,
)

__all__ = [
    "rasterize",
    "sliding_counts",
    "occupancy_window",
    "bias_mat",
    "nuc_scores",
    "gauss_smooth",
    "local_max_candidates",
    "greedy_select",
]
