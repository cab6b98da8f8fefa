"""The inputs the benchmark makes and hands to both the program and the
reference: the V-plot template and the Tn5 PWM, each from the
configuration's stated construction, and the dataset from the seed
(gpubench/data.py).

The template is the synthetic V-plot of the chain's definition:
T[s, k] ~ rho(s) phi(k; 0, sigma(s)), rho = N(147, 22), sigma(s) = 4 +
|s - 147| / 4, over sizes [lower, upper) and width offsets, made symmetric,
smoothed by a gaussian of sd (size, position) with zero padding and a
radius of four sds, clipped at 0 and normalised to sum 1. The PWM is the
synthetic Tn5 preference: 19 columns, up = 9, a palindromic GC preference
under a gaussian envelope, made reverse-complement symmetric.
"""
from __future__ import annotations

import numpy as np


def _gauss_1d(x: np.ndarray, sd: float, axis: int) -> np.ndarray:
    """Zero-padded gaussian smoothing along ``axis`` (radius round(4 sd))."""
    if sd <= 0:
        return x
    r = int(4.0 * sd + 0.5)
    t = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (t / sd) ** 2)
    k /= k.sum()
    x = np.moveaxis(x, axis, -1)
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(r, r)])
    out = np.lib.stride_tricks.sliding_window_view(xp, 2 * r + 1, axis=-1) @ k[::-1]
    return np.moveaxis(out, -1, axis)


def vplot_template(lower: int, upper: int, width: int, sd_size: float,
                   sd_pos: float) -> np.ndarray:
    """[upper - lower, width] float64 template."""
    sizes = np.arange(lower, upper, dtype=np.float64)
    k = np.arange(width, dtype=np.float64) - width // 2
    rho = np.exp(-0.5 * ((sizes - 147.0) / 22.0) ** 2)
    sigma = 4.0 + np.abs(sizes - 147.0) / 4.0
    phi = np.exp(-0.5 * (k[None, :] / sigma[:, None]) ** 2) / sigma[:, None]
    m = rho[:, None] * phi
    m = 0.5 * (m + m[:, ::-1])
    m = _gauss_1d(_gauss_1d(m, sd_size, 0), sd_pos, 1)
    m = np.clip(m, 0.0, None)
    return m / m.sum()


def tn5_pwm():
    """(probs [4, 19] over A, C, G, T, up)."""
    L, up = 19, 9
    k = np.arange(L) - up
    env = 0.35 * np.exp(-0.5 * (k / 3.0) ** 2)
    gc = env * np.cos(np.pi * k / 4.0)
    probs = np.exp(np.vstack([-gc, gc, gc, -gc]))
    probs /= probs.sum(axis=0, keepdims=True)
    probs = 0.5 * (probs + probs[::-1, ::-1])
    probs /= probs.sum(axis=0, keepdims=True)
    return probs, up
