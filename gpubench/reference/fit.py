"""The fragment-size histogram and the two-component mixture fit, in
float64 NumPy.

The histogram counts the adjusted sizes in [lower, upper) of fragments
whose midpoint lies in a merged peak. The mixture is a truncated
exponential for nucleosome-free fragments, fitted by Newton's method on
[nfr_lo, nfr_hi], and a nucleosomal component found by a fixed number of
EM rounds on the residual, smoothed by a gaussian and ramped in over
[ramp_lo, ramp_hi]. log_mix[s, g] = log(g p_nuc(s) + (1 - g) p_nfr(s) +
floor) over an even alpha grid of [0, 1]; q(s) is the histogram over the
template's size rows, normalised.
"""
from __future__ import annotations

import numpy as np


def size_histogram(frags: dict, merged: list, lower: int, upper: int) -> np.ndarray:
    """frags: chrom -> (mids, sizes) sorted by midpoint; merged: (chrom,
    start, end) peaks. int64 counts over [lower, upper)."""
    h = np.zeros(upper - lower, np.int64)
    for chrom, a, b in merged:
        mids, sizes = frags[chrom]
        i, j = np.searchsorted(mids, [a, b], side="left")
        s = sizes[i:j]
        s = s[(s >= lower) & (s < upper)]
        h += np.bincount(s - lower, minlength=upper - lower)
    return h


def _gauss(sigma: float) -> np.ndarray:
    if sigma <= 0:
        return np.array([1.0])
    hw = max(1, int(round(3 * sigma)))
    x = np.arange(-hw, hw + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _tau(sizes: np.ndarray, counts: np.ndarray, lo: int, hi: int, iters: int) -> float:
    """MLE of tau of p(s) ~ exp(-s / tau) seen on [lo, hi]: the root of
    m = tau - L / (exp(L / tau) - 1), m the mean of s - lo."""
    sel = (sizes >= lo) & (sizes <= hi)
    s, c = sizes[sel], counts[sel]
    tot = c.sum()
    if tot <= 0:
        return 60.0
    L = float(hi - lo)
    m = float(((s - lo) * c).sum() / tot)
    m = min(max(m, 1e-3), L / 2 - 1e-9)
    tau = max(m, 1e-2)
    for _ in range(iters):
        z = L / tau
        ez = np.expm1(z)
        f = tau - L / ez - m
        df = 1.0 - (z * z) * (ez + 1.0) / (ez * ez)
        if df <= 1e-12:
            break
        tau = float(np.clip(tau - f / df, 1e-2, 1e6))
    return tau


def mixture(hist: np.ndarray, lower: int, p: dict):
    """(p_nuc, p_nfr) over sizes [lower, lower + len(hist)); ``p`` holds
    nfr_fit_lo, nfr_fit_hi, ramp_lo, ramp_hi, em_iters, newton_iters,
    smooth_sigma."""
    sizes = np.arange(lower, lower + len(hist), dtype=np.float64)
    counts = hist.astype(np.float64)
    pd = counts / max(counts.sum(), 1.0)
    tau = _tau(sizes, counts, p["nfr_fit_lo"], p["nfr_fit_hi"], p["newton_iters"])
    nfr = np.exp(-sizes / tau)
    nfr = nfr / nfr.sum()
    t = np.clip((sizes - p["ramp_lo"]) / (p["ramp_hi"] - p["ramp_lo"]), 0.0, 1.0)
    ramp = t * t * (3.0 - 2.0 * t)
    kern = _gauss(p["smooth_sigma"])

    def norm(x):
        s = x.sum()
        return x / s if s > 0 else np.full_like(x, 1.0 / len(x))

    w = 0.5
    nuc = norm(np.clip(pd - nfr, 0.0, None) * ramp)
    for _ in range(p["em_iters"]):
        r = w * nuc / (w * nuc + (1.0 - w) * nfr + 1e-300)
        w = min(max(float((pd * r).sum()), 1e-6), 1.0 - 1e-6)
        nuc = norm(np.convolve(pd * r, kern, mode="same") * ramp)
    return nuc, nfr


def log_mix(nuc: np.ndarray, nfr: np.ndarray, grid_size: int, floor: float) -> np.ndarray:
    """[S, G] float64 log mixture over the alpha grid."""
    g = np.linspace(0.0, 1.0, grid_size)[None, :]
    return np.log(g * nuc[:, None] + (1.0 - g) * nfr[:, None] + floor)


def size_probs(hist: np.ndarray, lower: int, vlo: int, vhi: int) -> np.ndarray:
    """q(s) over the template's sizes [vlo, vhi)."""
    h = hist[vlo - lower:vhi - lower].astype(np.float64)
    tot = h.sum()
    return h / tot if tot > 0 else np.full_like(h, 1.0 / len(h))
