"""Per-window arithmetic of the chain in float64 NumPy, and the same
arithmetic at TF32 operand precision (the control).

Formulas (a frozen copy of the chain's definition, not of its code):

- adjusted fragments: left + 4, length - 9 (Tn5 offsets), midpoint
  left + (size - 1) // 2; lengths outside [1, max_size] dropped;
- raster: counts [S, W] of the window's fragments by size row
  (size - lower) and window-relative midpoint;
- occupancy: LL[p, g] = sum over positions within +-flank of p of
  counts[size] * log_mix[size, g]; the pick is the first argmax, the CI the
  first and last grid index whose LL is within ci_drop of the best, an
  empty position (no fragment in its window) reads 0 / 0 / 1;
- log bias: B[p] = sum_l log(pwm[base(p - up + l), l] / 0.25), N and
  positions off the chromosome adding 0;
- bias matrix: B0[s, p] = exp(B[p - (s-1)//2] + B[p + s//2]) (0 outside
  the window), each row scaled to q(s) over [core_lo, core_hi);
- scores: the template sums of the fragment matrix against V and 1 and
  of the bias matrix against 1, V and V^2, then norm = (signal - n mu) /
  sqrt(n (mu2 - mu^2)), mu = (B0 . V) / (B0 . 1), where the variance clears
  var_floor and n > 0, else 0; positions without a full footprint are 0;
- u16 step of a row: (max - min) / 65535 over the row.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

U16_LEVELS = 65535.0


def adjust_fragments(lefts: np.ndarray, tlens: np.ndarray, max_size: int,
                     shift: int = 4, shrink: int = 9):
    """Raw read lefts and template lengths of one chromosome -> (mids
    int64, sizes int64), sorted by midpoint."""
    left = np.asarray(lefts, np.int64) + shift
    size = np.asarray(tlens, np.int64) - shrink
    keep = (size >= 1) & (size <= max_size)
    left, size = left[keep], size[keep]
    mid = left + (size - 1) // 2
    order = np.argsort(mid, kind="stable")
    return mid[order], size[order]


def window_fragments(mids: np.ndarray, sizes: np.ndarray, lo: int, hi: int):
    """Fragments with midpoint in [lo, hi)."""
    a, b = np.searchsorted(mids, [lo, hi], side="left")
    return mids[a:b], sizes[a:b]


def raster(mids_rel: np.ndarray, sizes: np.ndarray, lower: int, upper: int,
           width: int) -> np.ndarray:
    """[upper - lower, width] int64 counts; entries outside dropped."""
    keep = (mids_rel >= 0) & (mids_rel < width) & (sizes >= lower) & (sizes < upper)
    S = upper - lower
    idx = (sizes[keep] - lower) * width + mids_rel[keep]
    return np.bincount(idx, minlength=S * width).reshape(S, width)


def sliding_counts(mat: np.ndarray, flank: int) -> np.ndarray:
    """[W, S]: counts of each size within +-flank of each position (zero
    outside the window); exact on integers."""
    S, W = mat.shape
    c = np.concatenate([np.zeros((S, 1), np.int64), np.cumsum(mat, axis=1)], axis=1)
    hi = np.minimum(np.arange(W) + flank + 1, W)
    lo = np.maximum(np.arange(W) - flank, 0)
    return (c[:, hi] - c[:, lo]).T


def tf32(x: np.ndarray) -> np.ndarray:
    """``x`` rounded to TF32 (10 stored mantissa bits, round to nearest
    even), as float64."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000
    return u.astype(np.uint32).view(np.float32).astype(np.float64)


class OccPicks(NamedTuple):
    best: np.ndarray  # [P] grid index
    first: np.ndarray
    last: np.ndarray
    empty: np.ndarray  # [P] bool
    ll: np.ndarray  # [P, G] float64 surface (the reference's)
    cert: np.ndarray  # [P] bool (the control's margin rule; True in f64)


def occupancy(mat: np.ndarray, log_mix: np.ndarray, flank: int, ci_drop: float,
              lo: int, n: int, control: bool = False, exact_tol: float = 0.0) -> OccPicks:
    """Picks over window positions [lo, lo + n). ``control``: the LL as a
    TF32 product (log_mix rounded to TF32) rounded to float32, picks and
    certified flags by the float32 margin rule with ``exact_tol``."""
    counts = sliding_counts(mat, flank)[lo:lo + n].astype(np.float64)  # [P, S]
    G = log_mix.shape[1]
    if control:
        ll = (counts @ tf32(log_mix)).astype(np.float32)
    else:
        ll = counts @ log_mix
    best = np.argmax(ll, axis=1)
    llmax = ll[np.arange(len(ll)), best]
    thr = llmax[:, None] - (np.float32(ci_drop) if control else ci_drop)
    ok = ll >= thr
    first = np.argmax(ok, axis=1)
    last = G - 1 - np.argmax(ok[:, ::-1], axis=1)
    empty = counts.sum(axis=1) == 0
    if control:
        second = np.max(np.where(np.arange(G) == best[:, None], -np.inf, ll), axis=1)
        margin = llmax - second
        ci_margin = np.min(np.abs(ll - thr), axis=1)
        cert = ((margin > exact_tol) & (ci_margin > exact_tol) & (best - first <= 31)
                & (last - best <= 31) & ~empty)
    else:
        cert = ~empty
    return OccPicks(best, first, last, empty, ll.astype(np.float64), cert)


def log_bias(codes: np.ndarray, chrom_len: int, ws: int, width: int, up: int,
             log_ratio: np.ndarray) -> np.ndarray:
    """[width] per-bp log bias of window columns [ws, ws + width) from the
    chromosome's base codes (0..3; anything else is N)."""
    L = log_ratio.shape[1]
    table = np.concatenate([log_ratio, np.zeros((1, L))])
    pos = ws - up + np.arange(width + L - 1)
    inside = (pos >= 0) & (pos < chrom_len)
    c = np.full(len(pos), 4, np.int64)
    c[inside] = codes[pos[inside]]
    c = np.where(c > 3, 4, c)
    ctx = np.lib.stride_tricks.sliding_window_view(c, L)  # [width, L]
    return table[ctx, np.arange(L)].sum(axis=1)


def bias_matrix(lb: np.ndarray, q: np.ndarray, lower: int, upper: int,
                core_lo: int, core_hi: int) -> np.ndarray:
    """[upper - lower, W] expected fragment matrix B0."""
    W = lb.shape[0]
    s = np.arange(lower, upper)[:, None]
    p = np.arange(W)[None, :]
    li = p - (s - 1) // 2
    ri = p + s // 2
    bl = np.where((li >= 0) & (li < W), lb[np.clip(li, 0, W - 1)], 0.0)
    br = np.where((ri >= 0) & (ri < W), lb[np.clip(ri, 0, W - 1)], 0.0)
    raw = np.exp(bl + br)
    core = raw[:, core_lo:core_hi].sum(axis=1)
    core = np.where(core > 0, core, 1.0)
    return raw * (q / core)[:, None]


def corr_rows(mat: np.ndarray, kern: np.ndarray) -> np.ndarray:
    """out[j] = sum_{s,k} kern[s, k] * mat[s, j + k] for the W - K + 1 valid
    j: one product [K, S] x [S, W], then the sum of its K shifted
    diagonals."""
    S, W = mat.shape
    K = kern.shape[1]
    H = np.ascontiguousarray(kern.T @ mat)  # [K, W]
    Wo = W - K + 1
    diag = np.lib.stride_tricks.as_strided(
        H, shape=(K, Wo), strides=(H.strides[0] + H.strides[1], H.strides[1]))
    return diag.sum(axis=0)


def corr_1d(x: np.ndarray, kern: np.ndarray) -> np.ndarray:
    """Valid 1-D cross-correlation of ``x`` [W] with ``kern`` [K]."""
    return np.lib.stride_tricks.sliding_window_view(x, len(kern)) @ kern


def nuc_norm(F: np.ndarray, b0: np.ndarray, vmat: np.ndarray, var_floor: float,
             control: bool = False) -> np.ndarray:
    """[W] norm track of one window (fragment and bias matrices [S, W]
    over the template's size rows). ``control``: the three template sums
    with 2-D structure take TF32 operands, everything else float32."""
    S, W = F.shape
    K = vmat.shape[1]
    half = K // 2
    F = F.astype(np.float64)
    if control:
        v32 = vmat.astype(np.float32).astype(np.float64)
        b32 = b0.astype(np.float32).astype(np.float64)
        signal = corr_rows(F, tf32(v32))
        vb = corr_rows(tf32(b32), tf32(v32))
        v2b = corr_rows(tf32(b32), tf32(v32 * v32))
        bsum = corr_1d(b32.sum(axis=0), np.ones(K))
    else:
        signal = corr_rows(F, vmat)
        vb = corr_rows(b0, vmat)
        v2b = corr_rows(b0, vmat * vmat)
        bsum = corr_1d(b0.sum(axis=0), np.ones(K))
    n = corr_1d(F.sum(axis=0), np.ones(K))
    dt = np.float32 if control else np.float64
    signal, n, vb, v2b, bsum = (a.astype(dt) for a in (signal, n, vb, v2b, bsum))
    safe_b = np.where(bsum > 0, bsum, dt(1.0))
    mu = vb / safe_b
    mu2 = v2b / safe_b
    var = n * (mu2 - mu * mu)
    ok = (var > var_floor) & (n > 0)
    norm_v = np.where(ok, (signal - n * mu) / np.sqrt(np.where(ok, var, dt(1.0))), dt(0.0))
    out = np.zeros(W, dt)
    out[half:half + len(norm_v)] = norm_v
    return out.astype(np.float64)


def u16_step(row: np.ndarray) -> float:
    """The u16 quantization step of a row: its range over 65535 levels."""
    return float((row.max() - row.min()) / U16_LEVELS)


def u16_roundtrip(row32: np.ndarray):
    """A float32 row through the per-row affine u16 quantization and back
    (float32 throughout): (decoded row, step)."""
    x = row32.astype(np.float32)
    mn = x.min()
    scale = np.float32((x.max() - mn) / np.float32(U16_LEVELS))
    safe = scale if scale > 0 else np.float32(1.0)
    q = np.clip(np.round((x - mn) / safe), 0, U16_LEVELS).astype(np.float32)
    return (mn + q * scale).astype(np.float64), float(scale)
